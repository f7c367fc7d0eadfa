"""PyTorch port: the TensorBoard event-file writer and the Logger's
TensorBoard sink, held to the JAX package's (``cglb_tpu/utils/tfevents.py``,
``cglb_tpu/utils/logging.py``): the RFC 3720 CRC vectors of
tests/test_tfevents.py, the same bytes for the same records at a fixed wall
time, the same parameter tags, and the same tags from a CPU CLI run."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import glob
import os
import struct

import numpy as np
import pytest

from cglb_tpu.utils import logging as jlog
from cglb_tpu.utils import tfevents as jtf
from cglb_tpu_torch.utils import logging as tlog
from cglb_tpu_torch.utils import tfevents as ttf


def test_crc32c_known_vectors():
    assert ttf._crc32c(b"") == 0x00000000
    assert ttf._crc32c(b"123456789") == 0xE3069283
    assert ttf._crc32c(bytes(32)) == 0x8A9136AA
    data = bytes(range(256)) * 3
    assert ttf._masked_crc(data) == jtf._masked_crc(data)


def _only_file(d):
    files = glob.glob(os.path.join(str(d), "events.out.tfevents.*"))
    assert len(files) == 1, files
    return files[0]


def _write(module, d):
    w = module.EventFileWriter(str(d))
    w.add_scalar("loss", 1.5, 0)
    w.add_scalar("loss", 0.75, 10)
    w.add_scalar("test/rmse", 0.33, 10)
    w.add_scalar("kernel/lengthscales[3]", -2.5e-7, 2 ** 40)
    w.close()
    return _only_file(d)


def test_writer_bytes_equal_the_jax_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(ttf.time, "time", lambda: 1787248651.25)
    got = open(_write(ttf, tmp_path / "torch"), "rb").read()
    want = open(_write(jtf, tmp_path / "jax"), "rb").read()
    assert got == want and len(got) > 100


def _records(path):
    """Payloads of a TFRecord file, each framing CRC checked."""
    out = []
    with open(path, "rb") as f:
        while header := f.read(8):
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == ttf._masked_crc(header)
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == ttf._masked_crc(payload)
            out.append(payload)
    return out


def _fields(buf):
    """{field number: [values]} of one protobuf message (varint, fixed64,
    length-delimited and fixed32 wire types)."""
    out, i = {}, 0

    def varint():
        nonlocal i
        shift = value = 0
        while True:
            b = buf[i]
            i += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return value

    while i < len(buf):
        key = varint()
        num, wire = key >> 3, key & 7
        if wire == 0:
            value = varint()
        elif wire == 1:
            value, i = struct.unpack("<d", buf[i:i + 8])[0], i + 8
        elif wire == 2:
            n = varint()
            value, i = buf[i:i + n], i + n
        else:
            value, i = struct.unpack("<f", buf[i:i + 4])[0], i + 4
        out.setdefault(num, []).append(value)
    return out


def _scalars(path):
    """[(step, tag, value)] of an event file's scalar records."""
    out = []
    records = _records(path)
    assert b"brain.Event:2" in records[0]
    for payload in records[1:]:
        event = _fields(payload)
        for value in _fields(event[5][0])[1]:
            v = _fields(value)
            out.append((event.get(2, [0])[0], v[1][0].decode(), v[2][0]))
    return out


def test_framing_and_values_read_back(tmp_path):
    got = _scalars(_write(ttf, tmp_path))
    assert [(s, t) for s, t, _ in got] == [
        (0, "loss"), (10, "loss"), (10, "test/rmse"),
        (2 ** 40, "kernel/lengthscales[3]")]
    np.testing.assert_allclose([v for _, _, v in got],
                               [1.5, 0.75, 0.33, -2.5e-7], rtol=1e-7)


def test_tb_format_parameters_equal_jax():
    params = {".kernel.variance": np.asarray(1.2),
              ".kernel.lengthscales": np.asarray([0.5, 2.0, 3.0]),
              ".likelihood.variance": np.asarray([0.1]),
              "noise_variance": 0.3,
              ".inducing_variable.Z": np.ones((2, 3)),
              "v0": np.ones(4)}
    got = tlog._tb_format_parameters(params)
    assert got == jlog._tb_format_parameters(params)
    assert set(got) == {"kernel/variance", "kernel/lengthscales[0]",
                        "kernel/lengthscales[1]", "kernel/lengthscales[2]",
                        "likelihood/variance", "noise_variance"}


def _logger_scalars(module, d, metrics, params):
    logger = module.Logger(str(d), lambda: metrics, lambda: params,
                           holdout_interval=2)
    for _ in range(3):  # steps 0 and 2 are recorded
        logger(None)
    logger._tb.close()
    return _scalars(_only_file(d))


def test_logger_writes_the_jax_loggers_records(tmp_path):
    metrics = {"loss": 1.0, "train/rmse": 0.5, "cg/steps": 7.0,
               "skipme": 2.0, "test/nlpd": np.float64(0.25),
               "test/vector": np.ones(3)}
    params = {".kernel.variance": np.asarray(1.2),
              ".kernel.lengthscales": np.asarray([0.5, 2.0]),
              ".inducing_variable.Z": np.ones((2, 2))}
    got = _logger_scalars(tlog, tmp_path / "torch", metrics, params)
    want = _logger_scalars(jlog, tmp_path / "jax", metrics, params)
    strip = [(s, t, v) for s, t, v in got if t != "elapsed_time"]
    assert strip == [(s, t, v) for s, t, v in want if t != "elapsed_time"]
    assert {(s, t) for s, t, _ in got} == {(s, t) for s, t, _ in want}
    assert {s for s, _, _ in got} == {0, 2}


def test_logger_without_logdir_or_tensorboard_writes_nothing(tmp_path):
    assert tlog.Logger("", dict, dict)._tb is None
    logger = tlog.Logger(str(tmp_path), dict, dict, tensorboard=False)
    logger(None)
    assert logger._tb is None and not os.listdir(tmp_path)


def test_cli_run_writes_events_with_the_jax_loggers_tags(tmp_path,
                                                          monkeypatch):
    """A small CPU CLI run leaves results, logs, model and an event file
    whose tags at each recorded step are those the JAX Logger writes for
    the same parameters and metrics (read back from logs.json)."""
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.utils.serialization import load_json

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    run = tmp_path / "run"
    cli.main(["-t", "fp64", "-l", str(run), "-s", "0", "--device", "cpu",
              "train", "-n", "3", "--holdout-interval", "2", "-d",
              "synth_300x2", "-o", "adam_0.01", "cglb", "-m", "cglb", "-k",
              "Matern32", "-i", "cv", "-M", "12"])
    for name in ("results.json", "logs.json", "model.json"):
        assert (run / name).exists(), name
    got = _scalars(_only_file(run))
    logs = load_json(run / "logs.json")
    keys = [k for k in logs if k.startswith(("train", "test", "cg/", "loss"))
            and not k.endswith("-per-feval")]
    assert {"loss", "test/rmse", "cg/steps"} <= set(keys)
    for i, step in enumerate(logs["iteration"]):
        metrics = {k: logs[k][i] for k in keys}
        params = {k: np.asarray(v) for k, v in logs["params"][i].items()}
        want = _logger_scalars(jlog, tmp_path / f"jax{i}", metrics, params)
        want_tags = {t for s, t, _ in want if s == 0}
        got_here = {t: v for s, t, v in got if s == step}
        assert set(got_here) == want_tags
        assert {"elapsed_time", "loss", "kernel/variance",
                "kernel/lengthscales[1]", "noise_variance"} <= want_tags
        for _, t, v in want:
            if t != "elapsed_time" and t in got_here:
                assert got_here[t] == pytest.approx(v, rel=1e-6)
