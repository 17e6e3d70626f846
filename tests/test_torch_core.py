"""repro_torch.core against repro.core: identical words and streams.

The cases of test_bitstream.py, test_fpdelta.py and
test_boolcodec_hilbert.py, run through both packages on the same numpy
inputs (JAX side under x64). Every packed word, code stream and
payload stream must be byte-identical, and each package must decode
the other's output. Also checks that the port imports neither jax nor
repro.
"""
import dataclasses
import os
import subprocess
import sys
import zlib

import jax
import ml_dtypes
import numpy as np
import pytest

from repro.core import bitstream as bs_ref
from repro.core import boolcodec as bc_ref
from repro.core import fpdelta as fp_ref
from repro.core import hilbert as hb_ref
from repro.core import pyramid as py_ref
from repro.sim import amrgen as amrgen_ref
from repro.sim import fields as fields_ref
from repro_torch.core import bitstream as bs_pt
from repro_torch.core import boolcodec as bc_pt
from repro_torch.core import fpdelta as fp_pt
from repro_torch.core import hilbert as hb_pt
from repro_torch.core import pyramid as py_pt
from repro_torch.sim import amrgen as amrgen_pt
from repro_torch.sim import fields as fields_pt

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def assert_same(a, b, path="obj"):
    """Recursive exact equality of codec outputs (dataclasses, lists,
    arrays with their dtypes, scalars)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


# ------------------------------------------------------------- bitstream

def _bit_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "basic":
        vals = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
        return vals, rng.integers(0, 33, 5000).astype(np.int32)
    if name == "all32":
        return (np.arange(100, dtype=np.uint32) * 40503,
                np.full(100, 32, np.int32))
    if name == "zero":
        return np.full(64, 0xDEADBEEF, np.uint32), np.zeros(64, np.int32)
    n = int(name.split("-")[1])       # property-style random lists
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return vals, rng.integers(0, 33, n).astype(np.int32)


@pytest.mark.parametrize("case", ["basic", "all32", "zero", "rand-1",
                                  "rand-7", "rand-64", "rand-300"])
def test_bitstream_words_identical(case):
    vals, nbits = _bit_case(case)
    with jax.enable_x64(True):
        words_ref, total_ref = bs_ref.pack_bits_host(vals, nbits)
        back_ref = bs_ref.unpack_bits_host(words_ref, nbits)
    words_pt, total_pt = bs_pt.pack_bits_host(vals, nbits)
    assert total_pt == total_ref == int(nbits.sum())
    assert_same(words_ref, words_pt)
    back_pt = bs_pt.unpack_bits_host(words_ref, nbits)
    assert_same(back_ref, back_pt)
    mask = np.where(nbits >= 32, np.uint32(0xFFFFFFFF),
                    ((np.uint64(1) << nbits.astype(np.uint64))
                     - np.uint64(1)).astype(np.uint32))
    np.testing.assert_array_equal(back_pt, vals & mask)


@pytest.mark.parametrize("values", [
    [np.nan, np.inf, -np.inf, -0.0, 5e-324, np.pi],
    list(np.random.default_rng(0).standard_normal(64) * 1e300),
])
def test_f64_pairs_identical(values):
    a = np.array(values, np.float64)
    hi_r, lo_r = bs_ref.f64_to_pair(a)
    hi_p, lo_p = bs_pt.f64_to_pair(a)
    assert_same((hi_r, lo_r), (hi_p, lo_p))
    back = bs_pt.pair_to_f64(hi_r, lo_r)
    assert back.tobytes() == a.tobytes()


def test_bf16_words_identical():
    x = (np.random.default_rng(1).standard_normal(257) * 1e3
         ).astype(np.float32)
    words = bs_ref.bf16_to_u32(x.astype(ml_dtypes.bfloat16))
    assert_same(words, bs_pt.bf16_to_u32(x))
    back = bs_pt.u32_to_bf16(words).float().numpy()
    np.testing.assert_array_equal(
        back, x.astype(ml_dtypes.bfloat16).astype(np.float32))


# ---------------------------------------------------------------- fpdelta

def _encode_both(pred, sons, **kw):
    with jax.enable_x64(True):
        blk_ref = fp_ref.encode(pred, sons, **kw)
    blk_pt = fp_pt.encode(pred, sons, **kw)
    assert_same(blk_ref, blk_pt)
    return blk_ref, blk_pt


@pytest.mark.parametrize("seed,zbits", [(0, 2), (1, 4), (2, 6), (3, 3)])
def test_fpdelta_streams_identical(seed, zbits):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(8 * (1 + seed * 9)) * 10.0 ** rng.integers(
        -300, 300)
    sons = vals.reshape(-1, 8)
    pred = sons.mean(axis=1)
    blk_ref, blk_pt = _encode_both(pred, sons, zbits=zbits)
    np.testing.assert_array_equal(fp_pt.decode(blk_ref, pred), sons)
    with jax.enable_x64(True):
        np.testing.assert_array_equal(fp_ref.decode(blk_pt, pred), sons)


def test_fpdelta_specials_identical():
    sons = np.array([[np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-310, np.pi,
                      -1.5]])
    pred = np.array([0.5])
    blk_ref, _ = _encode_both(pred, sons)
    out = fp_pt.decode(blk_ref, pred)
    assert out.tobytes() == sons.tobytes()


@pytest.mark.parametrize("width", [64, 32, 16])
def test_fpdelta_widths_identical(width):
    rng = np.random.default_rng(width)
    pred = rng.standard_normal(500)
    sons = pred[:, None] * (1 + 0.01 * rng.standard_normal((500, 8)))
    if width == 16:
        sons_ref = sons.astype(np.float32).astype(ml_dtypes.bfloat16)
        sons_pt = sons_ref.astype(np.float32)   # bf16 values, exactly
    elif width == 32:
        sons_ref = sons_pt = sons.astype(np.float32)
    else:
        sons_ref = sons_pt = sons
    with jax.enable_x64(True):
        blk_ref = fp_ref.encode(pred, sons_ref, width=width)
    blk_pt = fp_pt.encode(pred, sons_pt, width=width)
    assert_same(blk_ref, blk_pt)
    out = fp_pt.decode(blk_ref, pred)
    if width == 16:
        out = out.float().numpy()
    np.testing.assert_array_equal(out, np.asarray(sons_pt, out.dtype))


@pytest.mark.parametrize("kind", ["good-predictor", "random"])
def test_fpdelta_rates_identical(kind):
    rng = np.random.default_rng(1 if kind == "good-predictor" else 2)
    if kind == "good-predictor":
        pred = rng.lognormal(size=4096)
        sons = pred[:, None] * (1 + 1e-3 * rng.standard_normal((4096, 8)))
    else:
        pred = rng.standard_normal(1024)
        sons = rng.standard_normal((1024, 8))
    blk_ref, blk_pt = _encode_both(pred, sons)
    assert blk_ref.rate_vs_raw() == blk_pt.rate_vs_raw()


@pytest.mark.parametrize("zbits", [4, 6, 8])
def test_fpdelta_zbits_identical(zbits):
    pred = np.full(256, 1.0)
    sons = np.full((256, 8), 1.0)
    sons[:, 0] += 1e-15
    _encode_both(pred, sons, zbits=zbits)


def test_fpdelta_tree_streams_identical():
    kw = dict(min_level=2, max_level=5, threshold=1.3)
    t_ref = amrgen_ref.generate_tree(fields_ref.sedov(), **kw)
    t_pt = amrgen_pt.generate_tree(fields_pt.sedov(), **kw)
    for k, v in t_ref.to_arrays().items():
        assert_same(v, t_pt.to_arrays()[k], k)
    with jax.enable_x64(True):
        tc_ref = fp_ref.encode_tree_field(t_ref, "density")
    tc_pt = fp_pt.encode_tree_field(t_pt, "density")
    assert_same(tc_ref, tc_pt)
    dec = fp_pt.decode_tree_field(t_pt, tc_ref, to_level=2)
    with jax.enable_x64(True):
        want = fp_ref.decode_tree_field(t_ref, tc_ref, to_level=2)
    assert dec.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,dtype", [(1, "float64"), (77, "float32"),
                                     (1000, "float64"), (2999, "float32")])
def test_pyramid_streams_identical(n, dtype):
    x = np.random.default_rng(n).standard_normal(n).astype(dtype)
    with jax.enable_x64(True):
        pc_ref = py_ref.encode_pyramid(x)
    pc_pt = py_pt.encode_pyramid(x)
    assert_same(pc_ref, pc_pt)
    assert py_pt.decode_pyramid(pc_ref).tobytes() == x.tobytes()


def test_temporal_delta_streams_identical():
    rng = np.random.default_rng(4)
    prev = rng.standard_normal((64, 128)).astype(np.float32)
    cur = prev + 1e-5 * rng.standard_normal(prev.shape).astype(np.float32)
    with jax.enable_x64(True):
        dc_ref = py_ref.encode_delta(cur, prev)
    dc_pt = py_pt.encode_delta(cur, prev)
    assert_same(dc_ref, dc_pt)
    assert py_pt.decode_delta(dc_ref, prev).tobytes() == cur.tobytes()


# ------------------------------------------------------ boolcodec, hilbert

@pytest.mark.parametrize("case", ["rand-1", "rand-50", "rand-2000",
                                  "long-runs", "alternating"])
def test_boolcodec_bytes_identical(case):
    if case == "long-runs":
        bits = np.zeros(1_000_000, bool)
        bits[123_456:654_321] = True
    elif case == "alternating":
        bits = (np.arange(4096) % 2).astype(bool)
    else:
        n = int(case.split("-")[1])
        bits = np.random.default_rng(n).random(n) < 0.3
    enc = bc_ref.encode(bits)
    assert bc_pt.encode(bits) == enc
    np.testing.assert_array_equal(bc_pt.decode(enc, bits.size), bits)
    assert bc_pt.compression_vs_bitfield(bits) == \
        bc_ref.compression_vs_bitfield(bits)


@pytest.mark.parametrize("bits,n", [(1, 5), (3, 512), (4, 300), (6, 500)])
def test_hilbert_keys_identical(bits, n):
    rng = np.random.default_rng(bits * 1000 + n)
    coords = rng.integers(0, 2**bits, (n, 3)).astype(np.uint64)
    keys = hb_ref.coords_to_key(coords, bits)
    assert_same(keys, hb_pt.coords_to_key(coords, bits))
    assert_same(hb_ref.key_to_coords(keys, bits),
                hb_pt.key_to_coords(keys, bits))
    assert_same(hb_ref.domain_split(keys, 7), hb_pt.domain_split(keys, 7))


# ------------------------------------------------------------ isolation

def test_port_imports_neither_jax_nor_repro():
    """Importing every repro_torch module pulls in no jax and no repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'ml_dtypes')\n"
        "assert len(mods) > 30, mods\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
