"""Generic utilities: run directories, (de)serialization and the timer.

Same roles and byte formats as ``pcgmix_tpu/utils.py`` (reference
``utils.py:7-19``, ``:172-186``), so ``.dat`` datasets and
``performance.pkl`` files move freely between the two packages.
"""

from __future__ import annotations

import io
import os
import pickle
import zlib


def check_folder(save_dir: str) -> str:
    """Create ``save_dir`` if missing and return it."""
    os.makedirs(save_dir, exist_ok=True)
    return save_dir


def save_dict(d, filename: str) -> None:
    """Pickle a dict to disk."""
    with open(filename, "wb") as f:
        pickle.dump(d, f)


def load_dict(filename: str):
    """Unpickle a dict from disk."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def timer(start: float, end: float) -> str:
    """Format elapsed seconds as HH:MM:SS.ss (reference utils.py:21-24)."""
    hours, rem = divmod(end - start, 3600)
    minutes, seconds = divmod(rem, 60)
    return "{:0>2}:{:0>2}:{:05.2f}".format(int(hours), int(minutes), seconds)


def dict2file(dataset, path: str) -> None:
    """Write a dataset dict as a zlib-compressed pickle (the ``.dat`` format)."""
    buf = io.BytesIO()
    pickle.dump(dataset, buf)
    with open(path, "wb") as fd:
        fd.write(zlib.compress(buf.getbuffer()))


def file2dict(path: str):
    """Read a zlib-compressed pickled dataset dict."""
    with open(path, "rb") as fd:
        zbytes = fd.read()
    return pickle.loads(zlib.decompress(zbytes))
