"""The port's EC tools (ceph_tpu_torch/tools/ec_tool.py,
ec_non_regression.py) against the JAX package's, on the CPU (--device
cpu): the cases of tests/test_ec_tools.py, the committed corpus
reproduced by the port, and what both packages write equal."""
from __future__ import annotations

import os

import numpy as np
import pytest

from ceph_tpu.tools import ec_non_regression as ref_nr
from ceph_tpu.tools import ec_tool as ref_tool
from ceph_tpu_torch.tools import ec_non_regression as nr
from ceph_tpu_torch.tools import ec_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "ceph-erasure-code-corpus")
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("text", ["jerasure,k=4,m=2",
                                  "clay,k=8,m=4,d=11",
                                  "lrc,k=4,m=2,l=3,directory=/x/y"])
def test_parse_profile(text):
    assert ec_tool.parse_profile(text) == ref_tool.parse_profile(text)
    plugin, profile = ec_tool.parse_profile(text)
    assert profile["plugin"] == plugin == text.split(",")[0]


def test_parse_profile_rejects():
    with pytest.raises(ValueError):
        ec_tool.parse_profile("jerasure,k4")
    with pytest.raises(ValueError):
        ec_tool.parse_profile("")


@pytest.mark.parametrize("profile,lost", [
    ("jerasure,k=4,m=2", (1, 5)),
    ("jerasure,k=4,m=2,technique=liberation,w=7", (0, 4)),
    ("shec,k=4,m=3,c=2", (2, 6)),
    ("lrc,k=4,m=2,l=3", (1, 7)),
    ("clay,k=4,m=2,d=5", (3,)),
], ids=["jerasure", "liberation", "shec", "lrc", "clay"])
def test_ec_tool_roundtrip(tmp_path, profile, lost):
    rng = np.random.default_rng(0)
    src = tmp_path / "obj.bin"
    src.write_bytes(rng.integers(0, 256, 50000, dtype=np.uint8).tobytes())
    assert ec_tool.main(CPU + ["encode", profile, "1024", "all",
                               str(src)]) == 0
    n = len([p for p in os.listdir(tmp_path) if p.startswith("obj.bin.")])
    chunks = {i: (tmp_path / f"obj.bin.{i}").read_bytes() for i in range(n)}
    # the JAX package's tool writes the same chunk files
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_src = ref_dir / "obj.bin"
    ref_src.write_bytes(src.read_bytes())
    assert ref_tool.main(["encode", profile, "1024", "all",
                          str(ref_src)]) == 0
    for i, buf in chunks.items():
        assert (ref_dir / f"obj.bin.{i}").read_bytes() == buf, i
    for i in lost:
        os.unlink(f"{src}.{i}")
    chunk_files = ",".join(f"{src}.{i}" for i in range(n) if i not in lost)
    out = tmp_path / "out.bin"
    assert ec_tool.main(CPU + ["decode", profile, "1024", chunk_files,
                               str(out)]) == 0
    recovered = out.read_bytes()
    original = src.read_bytes()
    assert recovered[:len(original)] == original
    assert not any(recovered[len(original):])


def test_ec_tool_decode_rejects_bad_names(tmp_path):
    bad = tmp_path / "chunk.x"
    bad.write_bytes(b"\0" * 128)
    assert ec_tool.main(CPU + ["decode", "jerasure,k=2,m=1", "64",
                               str(bad), str(tmp_path / "o")]) == 1


@pytest.mark.parametrize("plugin", ["jerasure", "isa", "shec", "lrc", "clay",
                                    "cuda"])
def test_ec_tool_plugin_exists(plugin, capsys):
    assert ec_tool.main(["test-plugin-exists", plugin]) == 0
    assert f"plugin {plugin}: ok" in capsys.readouterr().out


def test_ec_tool_plugin_missing(capsys):
    assert ec_tool.main(["test-plugin-exists", "nope"]) == 1
    assert ec_tool.main(["test-plugin-exists", "tpu"]) == 1


@pytest.mark.parametrize("profile", [
    "jerasure,k=4,m=2", "isa,k=8,m=3", "shec,k=6,m=4,c=3", "lrc,k=4,m=2,l=3",
    "clay,k=8,m=4,d=11", "jerasure,k=5,m=2,technique=blaum_roth,w=6",
])
def test_ec_tool_calc_chunk_size(profile, capsys):
    assert ec_tool.main(CPU + ["calc-chunk-size", profile, "1048576"]) == 0
    size = int(capsys.readouterr().out.strip())
    assert ref_tool.main(["calc-chunk-size", profile, "1048576"]) == 0
    assert size == int(capsys.readouterr().out.strip())


def test_corpus_is_stable():
    """Every committed corpus entry re-encodes byte-identically through
    the port (the `tpu` entry through the port's `cuda` plugin)."""
    entries = os.listdir(os.path.join(CORPUS, "v1"))
    assert len(entries) == 11
    assert nr.check_all(CORPUS, "cpu") == []
    assert nr.main(["--corpus", CORPUS, "--check", "--all"] + CPU) == 0


@pytest.mark.parametrize("text", ["jerasure,k=2,m=1", "shec,k=4,m=3,c=2",
                                  "tpu,k=4,m=2"])
def test_corpus_detects_change(tmp_path, text):
    plugin, profile = ec_tool.parse_profile(text)
    d = nr.create(str(tmp_path), plugin, profile, 2048, "cpu")
    assert os.path.basename(d) == ref_nr.signature(plugin, profile)
    assert nr.check(str(tmp_path), plugin, profile, "cpu") == []
    # the JAX package reads what the port wrote
    assert ref_nr.check(str(tmp_path), plugin, profile) == []
    path = os.path.join(d, "1")
    buf = bytearray(open(path, "rb").read())
    buf[7] ^= 0x55
    open(path, "wb").write(bytes(buf))
    errors = nr.check(str(tmp_path), plugin, profile, "cpu")
    assert errors and "chunk 1" in errors[0]
    assert nr.main(["--corpus", str(tmp_path), "--check", "--profile",
                    text] + CPU) == 1


def test_corpus_missing_entry(tmp_path):
    plugin, profile = ec_tool.parse_profile("jerasure,k=2,m=1")
    errors = nr.check(str(tmp_path), plugin, profile, "cpu")
    assert errors and "no archived corpus" in errors[0]
