"""The port's native liaio bindings (lia_ral_tpu_torch/io/native.py)
against the numpy readers of both packages and the JAX package's batch
loader, mirroring tests/test_native_io.py, plus the read counters and
the build.

Tolerance: none — every read is exact (the files store f32, and the
native and numpy readers give the same arrays).  The port builds its own
copy of native/liaio.cpp (g++, the Makefile's flags) into its build
directory; the reference-fixture tests skip where the reference tree is
absent, as the JAX ones do.
"""

import glob
import os
import struct

import numpy as np
import pytest

from lia_ral_tpu.config import Config as JConfig
from lia_ral_tpu.io import features as jfeat
from lia_ral_tpu.tools import common as jcommon

from lia_ral_tpu_torch import _build
from lia_ral_tpu_torch.config import Config as TConfig
from lia_ral_tpu_torch.io import features as tfeat
from lia_ral_tpu_torch.io import native as tnative
from lia_ral_tpu_torch.tools import common as tcommon
from tests.conftest import REFERENCE, requires_reference


@pytest.fixture
def counts():
    tnative.reset_read_counts()
    return tnative.read_counts


def test_native_matches_python(tmp_path, rng, counts):
    data = rng.standard_normal((37, 13)).astype(np.float32)
    for fmt in ("SPRO3", "SPRO4", "RAW"):
        p = str(tmp_path / f"x_{fmt}.prm")
        tfeat.write_feature_file(p, data, fmt=fmt)
        nat = tnative.read_features_native(p, fmt, vect_size=13)
        assert nat is not None, fmt
        np.testing.assert_array_equal(nat, data)
        np.testing.assert_array_equal(nat, jfeat.read_feature_file(
            p, fmt=fmt, vect_size=13, use_native=False).data)
        # the full reader (native first) == the numpy reader, metadata too
        py = tfeat.read_feature_file(p, fmt=fmt, vect_size=13,
                                     use_native=False)
        full = tfeat.read_feature_file(p, fmt=fmt, vect_size=13)
        np.testing.assert_array_equal(full.data, py.data)
        assert (full.rate, full.kind, full.flag) == (py.rate, py.kind,
                                                     py.flag)
    # per format: one direct native read, one numpy, one native
    assert counts == {"native": 6, "numpy": 3}


@requires_reference
def test_native_reads_reference_fixture(counts):
    p = os.path.join(REFERENCE, "LIA_SpkDet/TrainWorld/test/test1.prm")
    nat = tnative.read_features_native(p, "SPRO3")
    assert nat is not None and nat.shape == (50, 34)
    py = tfeat.read_feature_file(p, fmt="SPRO3", use_native=False)
    np.testing.assert_array_equal(nat, py.data)
    ff = tfeat.read_feature_file(p, fmt="SPRO3")
    assert ff.kind == "FBCEPSTRA" and ff.flag == 9
    assert counts == {"native": 2, "numpy": 1}


def test_native_mask(rng):
    data = rng.standard_normal((20, 10)).astype(np.float32)
    idx = [0, 2, 5, 9]
    nat = tnative.apply_mask_native(data, idx)
    np.testing.assert_array_equal(nat, data[:, idx])


def test_native_bad_file_falls_back(tmp_path, counts):
    p = str(tmp_path / "garbage.prm")
    with open(p, "wb") as f:
        f.write(b"\x01\x02\x03")
    assert tnative.read_features_native(p, "SPRO3") is None
    with pytest.raises(ValueError, match="cannot parse"):
        tfeat.read_feature_file(p, fmt="SPRO3")
    assert counts == {"native": 0, "numpy": 0}


def test_native_batch_loader_matches_sequential(tmp_path, rng, counts):
    """liaio_read_batch (parallel worker pool) == per-file reads, with
    None for unreadable entries and featureServerMask applied through
    load_files_batch, equal to the JAX package's loader."""
    names, mats = [], []
    for i, n in enumerate([37, 512, 5, 129]):
        m = rng.standard_normal((n, 9)).astype(np.float32)
        nm = f"bf{i}"
        tfeat.write_feature_file(str(tmp_path / (nm + ".prm")), m,
                                 fmt="SPRO4")
        names.append(nm)
        mats.append(m)
    paths = [str(tmp_path / (n + ".prm")) for n in names]
    out = tnative.read_features_batch_native(
        paths + [str(tmp_path / "nope.prm")], "SPRO4")
    for m, o in zip(mats, out):
        np.testing.assert_array_equal(m, o)
    assert out[-1] is None
    assert counts == {"native": 4, "numpy": 0}
    base = {
        "featureFilesPath": str(tmp_path) + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "featureServerMask": "0-3,5",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
    }
    tnative.reset_read_counts()
    loaded = tcommon.load_files_batch(names + ["nope"], TConfig(base),
                                      batch=2)
    want = jcommon.load_files_batch(names + ["nope"], JConfig(base), batch=2)
    for m, o, j in zip(mats, loaded, want):
        np.testing.assert_array_equal(m[:, [0, 1, 2, 3, 5]], o)
        np.testing.assert_array_equal(j, o)
    assert loaded[-1] is None and want[-1] is None
    assert counts == {"native": 4, "numpy": 0}


@requires_reference
def test_batch_loader_reads_reference_fixtures():
    """The parallel batch loader parses the reference's own .prm
    fixtures identically to the per-file reader."""
    paths = sorted(glob.glob(
        REFERENCE + "/LIA_SpkDet/TrainWorld/test/*.prm"))[:4]
    assert paths
    out = tnative.read_features_batch_native(paths, "SPRO4")
    assert out is not None
    assert any(o is not None for o in out), "no fixture parsed natively"
    for p, o in zip(paths, out):
        ref = tfeat.read_feature_file(p, fmt="SPRO4").data
        if o is None:     # SPRO3-headered fixture → per-file path
            continue
        np.testing.assert_array_equal(o, ref)


def test_read_counts_show_the_path(tmp_path, rng, counts):
    """SPRO4 and SPRO3 (declared SPRO4: the header sniffing) files read
    natively; HTK has no native reader and goes to numpy; a batch that
    holds only files the native reader refuses goes file by file."""
    data = rng.standard_normal((21, 4)).astype(np.float32)
    paths = {}
    for fmt in ("SPRO4", "SPRO3", "HTK"):
        paths[fmt] = str(tmp_path / f"{fmt}.prm")
        tfeat.write_feature_file(paths[fmt], data, fmt=fmt)
    for fmt in ("SPRO4", "SPRO3"):
        got = tfeat.read_feature_file(paths[fmt], fmt="SPRO4")
        np.testing.assert_array_equal(got.data, data)
        want = jfeat.read_feature_file(paths[fmt], fmt="SPRO4",
                                       use_native=False)
        assert (got.rate, got.kind, got.flag) == (want.rate, want.kind,
                                                  want.flag)
    assert counts == {"native": 2, "numpy": 0}
    np.testing.assert_array_equal(
        tfeat.read_feature_file(paths["HTK"], fmt="HTK").data, data)
    assert counts == {"native": 2, "numpy": 1}
    cfg = TConfig({"featureFilesPath": str(tmp_path) + "/",
                   "loadFeatureFileFormat": "HTK",
                   "loadFeatureFileExtension": ".prm"})
    got = tcommon.load_files_batch(["HTK"], cfg)
    np.testing.assert_array_equal(got[0], data)
    assert counts == {"native": 2, "numpy": 2}


def test_spro4_variable_header_metadata(tmp_path, rng):
    """A SPro 4 file with its optional <header> block: the native read
    returns the numpy reader's rate and flag."""
    data = rng.standard_normal((9, 3)).astype(np.float32)
    p = str(tmp_path / "h.prm")
    with open(p, "wb") as f:
        f.write(b"<header>\nfoo = bar;\n</header>\n")
        f.write(struct.pack("<HIf", 3, 9, 50.0))
        f.write(data.tobytes())
    got = tfeat.read_feature_file(p, fmt="SPRO4")
    want = tfeat.read_feature_file(p, fmt="SPRO4", use_native=False)
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.rate, got.flag) == (want.rate, want.flag) == (50.0, 9)


def test_failed_native_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    """A source that does not compile raises (no quiet fall back to
    numpy), and the message holds the compiler's output."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "liaio.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path / "src")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="liaio.cpp"):
        _build.host_build("liaio")
    assert not list((tmp_path / "build").glob("libliaio_*.so"))
