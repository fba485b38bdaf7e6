"""Serving: the port's ``serve.py`` against ``pcgmix_tpu.serve``.

The same weights (the JAX package's flax init, carried over by
``jax_to_torch``) in both packages' live classifiers give probabilities
within 1e-5 and equal recording predictions; the port's ``torch.export``
artifact round-trips; its container refuses a JAX ``.pcgx``, a wrong
magic, a truncated header and a wrong input shape with the JAX package's
messages; and both CLIs print the same lines."""

import json
import os
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.models import build_model as jbuild_model
from pcgmix_tpu.serve import Classifier as JClassifier
from pcgmix_tpu.serve import main as jmain
from pcgmix_tpu.train.loop import save_checkpoint
from pcgmix_tpu_torch import serve, utils
from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.train.convert import jax_to_torch

T, BATCH = 512, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset():
    return synthetic_physionet_dict(num_wavs_train=4, num_wavs_test=5,
                                    segments_per_wav=3, sig_len=T, seed=8)


@pytest.fixture(scope="module")
def test_split(dataset):
    return physionet_split(dataset, "test")


@pytest.fixture(scope="module", params=["resnet9-5k", "Potes"])
def weights(request):
    """(name, JAX model, numpy variables, the port's model holding them)."""
    name = request.param
    jmodel = jbuild_model(name, "PhysioNet", 2, train=False)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 4, T)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # non-trivial running statistics, so eval-mode BatchNorm is exercised
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(a.dtype),
        variables.get("batch_stats", {}))
    variables = {"params": variables["params"], "batch_stats": stats}
    model = build_model(name, 2, 4, T)
    model.load_state_dict(jax_to_torch(name, variables["params"], stats))
    return name, jmodel, variables, model


def test_classifier_matches_reference(weights, test_split):
    name, jmodel, variables, model = weights
    ref = JClassifier(jmodel, variables["params"], variables["batch_stats"],
                      batch_size=BATCH)
    got = serve.Classifier(model, batch_size=BATCH, device="cpu")
    p_ref, p_got = ref.predict_proba(test_split.data), got.predict_proba(test_split.data)
    assert p_got.shape == p_ref.shape == (len(test_split.data), 2)
    np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=1e-5)
    r_ref = ref.predict_recordings(test_split.data, test_split.wav)
    r_got = got.predict_recordings(test_split.data, test_split.wav)
    assert [(p.wav, p.pred, p.num_segments) for p in r_got] == [
        (p.wav, p.pred, p.num_segments) for p in r_ref]
    np.testing.assert_allclose([p.prob_abnormal for p in r_got],
                               [p.prob_abnormal for p in r_ref], atol=1e-5)


def test_artifact_round_trip(weights, test_split, tmp_path):
    name, _, _, model = weights
    live = serve.Classifier(model, batch_size=BATCH, class_majority=True, device="cpu")
    path = str(tmp_path / "model.pcgt")
    header = live.export_artifact(path, (4, T), model_name=name)
    assert header["platforms"] == ["cpu"] and header["batch_size"] == BATCH
    exported = serve.ExportedClassifier(path)
    assert exported.class_majority and exported.input_shape == (4, T)
    np.testing.assert_array_equal(exported.predict_proba(test_split.data),
                                  live.predict_proba(test_split.data))
    assert exported.predict_recordings(test_split.data, test_split.wav) == \
        live.predict_recordings(test_split.data, test_split.wav)
    with pytest.raises(ValueError, match="does not match the artifact's input shape"):
        exported.predict_proba(test_split.data[:, :, :256])


def _container(path, magic, blob, payload=b""):
    with open(path, "wb") as f:
        f.write(magic + struct.pack("<I", len(blob)) + blob + payload)


def test_artifact_refusals(tmp_path):
    jax_art = tmp_path / "model.pcgx"
    _container(jax_art, b"PCGXSHLO", json.dumps({"format": 1}).encode())
    with pytest.raises(ValueError, match="not a pcgmix serving artifact.*pcgmix_tpu"):
        serve.ExportedClassifier(str(jax_art))
    wrong = tmp_path / "wrong.bin"
    wrong.write_bytes(b"NOTANART" + bytes(16))
    with pytest.raises(ValueError, match="not a pcgmix serving artifact$"):
        serve.ExportedClassifier(str(wrong))
    short = tmp_path / "short.pcgt"
    short.write_bytes(b"PCGXTEXP" + b"\x01")
    with pytest.raises(ValueError, match="truncated serving artifact header"):
        serve.ExportedClassifier(str(short))
    cut = tmp_path / "cut.pcgt"
    cut.write_bytes(b"PCGXTEXP" + struct.pack("<I", 100) + b"{}")
    with pytest.raises(ValueError, match="truncated serving artifact header"):
        serve.ExportedClassifier(str(cut))
    bad = tmp_path / "bad.pcgt"
    _container(bad, b"PCGXTEXP", b"\xff{")
    with pytest.raises(ValueError, match="corrupt serving artifact header"):
        serve.ExportedClassifier(str(bad))
    future = tmp_path / "future.pcgt"
    _container(future, b"PCGXTEXP", json.dumps({"format": 2}).encode())
    with pytest.raises(ValueError, match="unsupported artifact format 2"):
        serve.ExportedClassifier(str(future))


def test_cli_prints_the_reference_lines(weights, dataset, tmp_path, capsys):
    """Live and artifact CLIs of the port against the JAX package's live CLI
    on the same weights: the same recordings, predictions, segment counts
    and accuracy line; probabilities to their 4 printed decimals within
    one unit."""
    name, _, variables, model = weights
    dat = str(tmp_path / "p.dat")
    utils.dict2file(dataset, dat)
    msgpack = str(tmp_path / "model.msgpack")
    save_checkpoint(msgpack, types.SimpleNamespace(**variables))
    pth = str(tmp_path / "model.pth")
    torch.save(model.state_dict(), pth)
    common = ["--model", name, "--dataset-file", dat, "--batch-size", str(BATCH)]

    def lines(main, argv):
        main(argv)
        return [ln.split("\t") for ln in capsys.readouterr().out.splitlines()]

    ref = lines(jmain, ["--checkpoint", msgpack, *common])
    live = lines(serve.main, ["--checkpoint", pth, *common, "--device", "cpu"])
    art = str(tmp_path / "model.pcgt")
    exported = lines(serve.main, ["--checkpoint", pth, "--model", name, "--sig-len",
                                  str(T), "--export-to", art, "--batch-size", str(BATCH),
                                  "--device", "cpu"])
    assert exported[0][0].startswith(f"# exported {art}: ")
    served = lines(serve.main, ["--artifact", art, "--dataset-file", dat])
    assert os.path.getsize(art) > 0
    for got in (live, served):
        assert len(got) == len(ref) > 2
        assert got[-1] == ref[-1] and got[-1][0].startswith("# recording accuracy")
        for g, r in zip(got[:-1], ref[:-1]):
            assert [g[0], g[1], g[3]] == [r[0], r[1], r[3]]
            assert abs(float(g[2].split("=")[1]) - float(r[2].split("=")[1])) <= 1e-4


def test_cli_argument_errors(capsys):
    for argv in ([], ["--artifact", "a", "--checkpoint", "b"], ["--checkpoint", "b"]):
        with pytest.raises(SystemExit):
            serve.main(argv)


def test_entry_point_runs_on_cuda_unless_asked(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.Classifier(weights[3])
