"""Inference and serving (counterpart: ``pcgmix_tpu/serve.py``).

The reference has no serving path.  Like the JAX package, the port loads
a trained model once, runs cycles through the softmax forward at one fixed
batch (pad, then drop the padding), and aggregates per-segment
probabilities into per-recording decisions as the evaluation protocol does
(train_model.py:621-646; ``train/metrics.py::aggregate_recordings``).

Two modes:

- **Live** (:class:`Classifier`): the model rebuilt from the registry, its
  ``model.pth`` loaded, in eval mode.
- **Artifact** (:class:`ExportedClassifier`): one file written by
  :meth:`Classifier.export_artifact`, in the JAX package's container
  layout (magic, u32 little-endian header length, JSON header, payload)
  under a magic of its own.  The payload is a ``torch.export`` program of
  the batched softmax forward with the trained weights inside, so serving
  needs no model code and no checkpoint.  The program's constants live on
  the device it was exported on; the header names it under ``platforms``,
  and the artifact is served there.

CLI (as the JAX package's, with ``--device`` in place of ``--platforms``):
  python -m pcgmix_tpu_torch.serve --checkpoint runs/.../model.pth \\
      --model resnet9 --dataset-file physionet.dat --split test
  python -m pcgmix_tpu_torch.serve --checkpoint ... --model resnet9 \\
      --sig-len 2500 --export-to model.pcgt
  python -m pcgmix_tpu_torch.serve --artifact model.pcgt \\
      --dataset-file physionet.dat --split test
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import struct
from typing import Optional

import numpy as np
import torch
from torch import nn

# Artifact container: magic + u32 LE header length + JSON header + payload.
_ARTIFACT_MAGIC = b"PCGXTEXP"
_JAX_ARTIFACT_MAGIC = b"PCGXSHLO"  # pcgmix_tpu.serve's StableHLO artifacts
_ARTIFACT_FORMAT = 1


@dataclasses.dataclass
class Prediction:
    wav: str
    pred: int
    prob_abnormal: float
    num_segments: int


class _BatchedPredictor:
    """Pad-to-fixed-batch inference and recording aggregation.

    Subclasses provide ``self._forward`` ((batch_size, …) host array →
    (batch_size, classes) softmax probabilities), ``self.batch_size``,
    ``self.class_majority`` and ``self.num_classes``."""

    batch_size: int
    class_majority: bool
    num_classes: int = 2

    def predict_proba(self, data: np.ndarray) -> np.ndarray:
        """(N, …) cycles → (N, classes) softmax probabilities; inputs are
        padded to the service batch, so every call runs one shape."""
        n, bs = len(data), self.batch_size
        out = None
        for b in range(0, n, bs):
            chunk = data[b:b + bs]
            valid = len(chunk)
            if valid < bs:
                pad = np.zeros((bs - valid,) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            probs = self._forward(chunk)
            if out is None:
                out = np.zeros((n, probs.shape[1]), np.float32)
            out[b:b + valid] = probs[:valid]
        return out if out is not None else np.zeros((0, self.num_classes), np.float32)

    def predict_recordings(self, data: np.ndarray, wavs) -> list[Prediction]:
        """Per-cycle probabilities aggregated into per-recording predictions
        (the evaluation protocol's aggregation)."""
        from pcgmix_tpu_torch.train.metrics import aggregate_recordings

        agg = aggregate_recordings(self.predict_proba(data), wavs, self.class_majority)
        return [Prediction(w, pred, float(mean[1]) if len(mean) > 1 else 0.0, n)
                for w, (pred, mean, n) in agg.items()]


class _SoftmaxForward(nn.Module):
    """The model's eval forward followed by the softmax over classes."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.model(x), dim=1)


class Classifier(_BatchedPredictor):
    """Serve a live model: ``model`` in eval mode on ``device``."""

    def __init__(self, model: nn.Module, batch_size: int = 256,
                 class_majority: bool = False, num_classes: int = 2,
                 device: str = "cuda"):
        from pcgmix_tpu_torch.train.loop import resolve_device

        self.device = resolve_device(device)
        self.net = _SoftmaxForward(model).to(self.device).eval()
        self.batch_size = batch_size
        self.class_majority = class_majority
        self.num_classes = num_classes

    @torch.no_grad()
    def _forward(self, data: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(self.device)
        return self.net(x).cpu().numpy()

    @classmethod
    def from_checkpoint(cls, path: str, model_name: str = "resnet9",
                        dataset: str = "PhysioNet", num_channels: int = 4,
                        sig_len: int = 2500, num_classes: int = 2,
                        device: str = "cuda", compute_dtype: Optional[str] = None, **kw) -> "Classifier":
        """A ``model.pth`` that ``train_model`` wrote, into the registry's
        ``model_name`` built for ``dataset`` inputs (``sig_len`` is the 1-D
        cycle length; a spectrogram dataset takes its size from its name)
        and ``compute_dtype`` (the weights are float32 in either dtype, so a
        checkpoint serves in both; its :meth:`export_artifact` exports the
        model in that dtype)."""
        from pcgmix_tpu_torch.models import build_model

        shape = sample_input_shape(dataset, num_channels, sig_len)
        model = build_model(model_name, num_classes, shape[1], shape[-1], dataset=dataset,
                            freq=shape[-2] if len(shape) == 4 else None,
                            compute_dtype=compute_dtype)
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        return cls(model, num_classes=num_classes, device=device, **kw)

    def export_artifact(self, path: str, input_shape: tuple, model_name: str = "",
                        dtype=torch.float32) -> dict:
        """Write the batched softmax forward, weights inside, as a
        ``torch.export`` artifact at ``path``; returns its header.

        ``input_shape`` is one sample's shape, (C, L) in 1-D or (1, S, S)
        for spectrograms; the program's batch is this classifier's
        ``batch_size``.  It is exported on, and serves on, this
        classifier's device."""
        example = torch.zeros((self.batch_size, *input_shape), dtype=dtype,
                              device=self.device)
        with torch.no_grad():
            program = torch.export.export(self.net, (example,))
            num_classes = int(self.net(example).shape[-1])
        buf = io.BytesIO()
        torch.export.save(program, buf)
        header = {
            "format": _ARTIFACT_FORMAT,
            "model": model_name,
            "batch_size": self.batch_size,
            "input_shape": list(input_shape),
            "dtype": str(dtype).replace("torch.", ""),
            "num_classes": num_classes,
            "platforms": [self.device.type],
            "class_majority": bool(self.class_majority),
            "torch": torch.__version__,
        }
        blob = json.dumps(header, sort_keys=True).encode("utf-8")
        with open(path, "wb") as f:
            f.write(_ARTIFACT_MAGIC)
            f.write(struct.pack("<I", len(blob)))
            f.write(blob)
            f.write(buf.getvalue())
        return header


def read_artifact(path: str) -> tuple[dict, bytes]:
    """(header, payload) of an artifact; raises ValueError for anything but
    an artifact of this package's format."""
    with open(path, "rb") as f:
        magic = f.read(len(_ARTIFACT_MAGIC))
        if magic != _ARTIFACT_MAGIC:
            what = (" (a pcgmix_tpu StableHLO artifact: serve it with "
                    "pcgmix_tpu.serve)" if magic == _JAX_ARTIFACT_MAGIC else "")
            raise ValueError(f"{path}: not a pcgmix serving artifact{what}")
        head = f.read(4)
        if len(head) < 4:
            raise ValueError(f"{path}: truncated serving artifact header")
        (hlen,) = struct.unpack("<I", head)
        blob = f.read(hlen)
        if len(blob) < hlen:
            raise ValueError(f"{path}: truncated serving artifact header")
        try:
            header = json.loads(blob.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt serving artifact header ({e})") from e
        payload = f.read()
    if header.get("format") != _ARTIFACT_FORMAT:
        raise ValueError(f"{path}: unsupported artifact format {header.get('format')}")
    return header, payload


class ExportedClassifier(_BatchedPredictor):
    """Serve from an artifact written by :meth:`Classifier.export_artifact`,
    with no model code or checkpoint, on the device it was exported on."""

    def __init__(self, path: str, class_majority: bool | None = None):
        from pcgmix_tpu_torch.train.loop import resolve_device

        self.header, payload = read_artifact(path)
        self.device = resolve_device(self.header["platforms"][0])
        self._program = torch.export.load(io.BytesIO(payload)).module()
        self.batch_size = int(self.header["batch_size"])
        self.input_shape = tuple(self.header["input_shape"])
        self.dtype = getattr(torch, self.header["dtype"])
        self.num_classes = int(self.header.get("num_classes", 2))
        self.class_majority = (bool(self.header["class_majority"])
                               if class_majority is None else class_majority)

    def predict_proba(self, data: np.ndarray) -> np.ndarray:
        if tuple(data.shape[1:]) != self.input_shape:
            raise ValueError(
                f"data shape {tuple(data.shape[1:])} does not match the "
                f"artifact's input shape {self.input_shape} "
                f"(model {self.header.get('model') or 'unknown'})"
            )
        return super().predict_proba(data)

    @torch.no_grad()
    def _forward(self, data: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device, self.dtype)
        return self._program(x).cpu().numpy()


#: a spectrogram dataset's image side (JAX ``models/registry.py:60-64``)
SPEC_DATASET_SIZES = {"PhysioNet(spec128)": 128, "UMC(spec128)": 128, "UMC(spec64)": 64}


def sample_input_shape(dataset: str, num_channels: int, sig_len: int) -> tuple:
    """A batch-1 model input for a config (JAX ``models/registry.py:67-76``):
    (1, 1, S, S) for a spectrogram dataset, S from its name; (1, C, L)."""
    if dataset in SPEC_DATASET_SIZES:
        s = SPEC_DATASET_SIZES[dataset]
        return (1, 1, s, s)
    return (1, num_channels, sig_len)


def main(argv=None):
    p = argparse.ArgumentParser(description="Classify recordings with a checkpoint")
    p.add_argument("--checkpoint", help="model.pth checkpoint (live mode)")
    p.add_argument("--artifact", help="torch.export artifact to serve from")
    p.add_argument("--model", default="resnet9")
    p.add_argument("--dataset", default="PhysioNet")
    p.add_argument("--dataset-file", help="packed dataset dict to classify")
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--num-channels", type=int, default=4)
    p.add_argument("--class-majority", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="majority-vote recording aggregation; with --artifact the "
                        "default comes from the artifact header "
                        "(--no-class-majority overrides it off)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--export-to", metavar="PATH",
                   help="write a torch.export serving artifact and exit")
    p.add_argument("--sig-len", type=int, default=2500,
                   help="1-D cycle length for --export-to (ignored with "
                        "--dataset-file, which fixes the shape)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve (and export) on; 'cpu' only when "
                        "asked for.  An artifact serves on its export device")
    args = p.parse_args(argv)

    if args.artifact and (args.checkpoint or args.export_to):
        p.error("--artifact replaces --checkpoint and cannot be re-exported")
    if not args.artifact and not args.checkpoint:
        p.error("one of --checkpoint or --artifact is required")
    if not args.export_to and not args.dataset_file:
        p.error("--dataset-file is required unless --export-to is given")

    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.data.datasets import ArrayDataset

    ds = None
    if args.dataset_file:
        d = utils.file2dict(args.dataset_file)
        split = d[args.split] if args.split in d else d
        ds = ArrayDataset.from_dict(
            split, args.num_channels,
            spectrogram=args.dataset.endswith(")") and "spec" in args.dataset,
        )

    sig_len = ds.data.shape[-1] if ds is not None else args.sig_len
    if args.artifact:
        clf = ExportedClassifier(args.artifact, class_majority=args.class_majority)
    else:
        clf = Classifier.from_checkpoint(
            args.checkpoint, args.model, args.dataset, args.num_channels,
            sig_len=sig_len, class_majority=bool(args.class_majority),
            batch_size=args.batch_size, device=args.device,
        )

    if args.export_to:
        input_shape = sample_input_shape(args.dataset, args.num_channels, sig_len)[1:]
        header = clf.export_artifact(args.export_to, input_shape, model_name=args.model)
        print(f"# exported {args.export_to}: {json.dumps(header, sort_keys=True)}")
        if ds is None:
            return

    preds = clf.predict_recordings(ds.data, ds.wav)
    for pr in preds:
        print(f"{pr.wav}\tpred={pr.pred}\tp_abnormal={pr.prob_abnormal:.4f}"
              f"\tsegments={pr.num_segments}")
    if ds.label is not None and len(ds.label):
        by_wav = {w: int(t) for w, t in zip(ds.wav, ds.label)}
        acc = np.mean([pr.pred == by_wav[pr.wav] for pr in preds]) * 100
        print(f"# recording accuracy vs labels: {acc:.2f}%")


if __name__ == "__main__":
    main()
