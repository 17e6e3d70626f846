"""Codec kernels B6-B9: the port's codec entry points against the reference.

``repro_torch.kernels.ops``' codec half (the plain twins on CPU tensors)
must give the words of ``repro.kernels.ops`` (``pallas_interpret`` and
``ref``, as ``tests/test_kernels.py`` runs them) and of the host codec
(``core.fpdelta``), bit for bit: this is integer work, so there is no
tolerance anywhere. The ``gpu`` cases hold each CUDA kernel against its
twin on the card and skip where there is none.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitstream as bs_ref
from repro.kernels import ops as ops_ref
from repro.kernels import ref as ref_ref
from repro_torch.core import fpdelta
from repro_torch.kernels import codec, cudalib, ops, ref
from repro_torch.sim import amrgen, fields

S = 8


def groups(g: int, width: int, seed: int):
    """(S, G) uint32 (pred_hi, pred_lo, son_hi, son_lo) as the reference's
    kernel tests make them, with the float predictors and sons."""
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal(g)
    sons = pred[:, None] * (1 + 0.01 * rng.standard_normal((g, S)))
    return words_of(pred, sons, width), pred, sons


def words_of(pred, sons, width: int):
    g = sons.shape[0]
    p = np.broadcast_to(pred[:, None], (g, S))
    zero = np.zeros((g, S), np.uint32)
    if width == 64:
        (ph, plo), (sh, slo) = bs_ref.f64_to_pair(p), bs_ref.f64_to_pair(sons)
    elif width == 32:
        ph, plo = zero, bs_ref.f32_to_u32(p.astype(np.float32))
        sh, slo = zero, bs_ref.f32_to_u32(sons.astype(np.float32))
    else:
        ph, plo = zero, bs_ref.bf16_to_u32(p)
        sh, slo = zero, bs_ref.bf16_to_u32(sons)
    return [np.ascontiguousarray(a.T) for a in (ph, plo, sh, slo)]


def port(words):
    """uint32 numpy words -> the port's int32 word tensors."""
    return [torch.from_numpy(w.view(np.int32)) for w in words]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def cut(code_words, payload_words, code_bits, payload_bits):
    """Stream words up to their bit counts, as uint32 numpy arrays."""
    nc = max(1, (int(code_bits) + 31) // 32)
    npl = max(1, (int(payload_bits) + 31) // 32)
    return (np.asarray(code_words).view(np.uint32)[:nc],
            np.asarray(payload_words).view(np.uint32)[:npl])


@pytest.mark.parametrize("width", [64, 32, 16])
@pytest.mark.parametrize("g", [8, 100, 1024, 5000])
def test_encode_groups_bits_vs_reference(g, width):
    words, _, _ = groups(g, width, seed=g + width)
    want = ops_ref.encode_groups_bits(*map(jnp.asarray, words), zbits=4,
                                      width=width, backend="pallas_interpret")
    oracle = ref_ref.group_residues_ref(*map(jnp.asarray, words), 4, width)
    for backend in (None, "ref"):
        got = ops.encode_groups_bits(*port(words), zbits=4, width=width,
                                     backend=backend)
        for a, b, c in zip(got, want, oracle):
            np.testing.assert_array_equal(a.numpy().view(np.asarray(b).dtype),
                                          np.asarray(b))
            np.testing.assert_array_equal(np.asarray(b), np.asarray(c))


@pytest.mark.parametrize("zbits", [2, 4, 8])
def test_zbits_sweep(zbits):
    words, _, _ = groups(600, 64, seed=zbits)
    want = ops_ref.encode_groups_bits(*map(jnp.asarray, words), zbits=zbits,
                                      width=64, backend="pallas_interpret")
    got = ops.encode_groups_bits(*port(words), zbits=zbits, width=64)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].max()) <= (1 << zbits) - 1


@pytest.mark.parametrize("width", [64, 32, 16])
def test_decode_groups_bits_round_trip(width):
    words, _, _ = groups(777, width, seed=9)
    rh, rl, _ = ops.encode_groups_bits(*port(words), width=width)
    sh, slo = ops.decode_groups_bits(rh, rl, *port(words)[:2])
    want = ops_ref.decode_groups_bits(np.asarray(u32(rh)), u32(rl),
                                      words[0], words[1],
                                      backend="pallas_interpret")
    np.testing.assert_array_equal(u32(sh), words[2])
    np.testing.assert_array_equal(u32(slo), words[3])
    np.testing.assert_array_equal(u32(sh), np.asarray(want[0]))
    np.testing.assert_array_equal(u32(slo), np.asarray(want[1]))


def test_clz_twin_matches_lax():
    """Words with the top bit set: an arithmetic int32 shift gets them
    wrong, the twin's masked int64 words do not."""
    rng = np.random.default_rng(0)
    x = np.concatenate([[0, 1, 2, 3, 0x80000000, 0xFFFFFFFF],
                        rng.integers(0, 2**32, 1000, dtype=np.uint64)
                        ]).astype(np.uint32)
    want = np.asarray(jax.lax.clz(jnp.asarray(x))).astype(np.int32)
    got = ref.clz32_ref(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ref.clz32_ref(jnp.asarray(x))))


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 32 * 1024 + 17])
def test_bitfield_pack_unpack_vs_reference(n):
    rng = np.random.default_rng(n)
    bits = (rng.random(n) < 0.4).astype(np.uint32)
    want = np.asarray(ops_ref.bitfield_pack(bits, backend="pallas_interpret"))
    np.testing.assert_array_equal(
        want, np.asarray(ops_ref.bitfield_pack(bits, backend="ref")))
    for flags in (torch.from_numpy(bits.astype(bool)),
                  torch.from_numpy(bits.view(np.int32))):
        words = ops.bitfield_pack(flags)
        assert words.dtype == torch.int32 and words.shape == (-(-n // 32),)
        np.testing.assert_array_equal(u32(words), want)
        back = ops.bitfield_unpack(words, n)
        np.testing.assert_array_equal(back.numpy(), bits)
    padded = np.packbits(bits.astype(bool), bitorder="little")
    padded = np.pad(padded, (0, (-padded.size) % 4)).view("<u4")
    np.testing.assert_array_equal(u32(words), padded)


@pytest.mark.parametrize("width", [64, 32, 16])
@pytest.mark.parametrize("g", [1000, 2048])
def test_compress_bits_words_vs_reference_and_host_codec(g, width):
    rng = np.random.default_rng(5 + g + width)
    pred = rng.lognormal(size=g)
    sons = pred[:, None] * (1 + 1e-3 * rng.standard_normal((g, S)))
    words = words_of(pred, sons, width)
    want = ops_ref.compress_bits(*map(jnp.asarray, words), zbits=4,
                                 width=width, backend="ref")
    got = ops.compress_bits(*port(words), zbits=4, width=width)
    assert [int(b) for b in got[2:]] == [int(b) for b in want[2:]]
    for a, b in zip(cut(*got), cut(*want)):
        np.testing.assert_array_equal(a, b)
    host = fpdelta.encode(pred, sons, width=width)
    np.testing.assert_array_equal(cut(*got)[0], host.codes)
    np.testing.assert_array_equal(cut(*got)[1], host.payload)
    sh, slo = ops.decompress_bits(*got[:2], *port(words)[:2], width=width)
    np.testing.assert_array_equal(u32(sh), words[2])
    np.testing.assert_array_equal(u32(slo), words[3])


@pytest.mark.parametrize("zbits", [2, 4, 8])
@pytest.mark.parametrize("width", [64, 32, 16])
def test_compress_bits_block_layout_vs_reference(width, zbits):
    """``compress_bits`` packs B6's one buffer (the residues in stream
    order) as its payload values: its words and bit counts are the
    reference's at every width and zbits, through the wrapper and
    through the twin — against ``ref`` on a ragged G, and against
    ``pallas_interpret`` on G = 1024, the Pallas kernel's block (its
    caller pads G to it)."""
    rng = np.random.default_rng(width + zbits)
    for backend, g in (("ref", 333), ("pallas_interpret", 1024)):
        pred = rng.lognormal(size=g)
        sons = pred[:, None] * (1 + 1e-4 * rng.standard_normal((g, S)))
        words = words_of(pred, sons, width)
        want = ops_ref.compress_bits(*map(jnp.asarray, words), zbits=zbits,
                                     width=width, backend=backend)
        for mine in (None, "ref"):
            got = ops.compress_bits(*port(words), zbits=zbits, width=width,
                                    backend=mine)
            assert [int(b) for b in got[2:]] == [int(b) for b in want[2:]]
            for a, b in zip(cut(*got), cut(*want)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [64, 32, 16])
@pytest.mark.parametrize("g", [5, 333])
def test_encode_groups_are_views_of_one_stream_ordered_block(g, width):
    """B6's (S, G) residues and (G,) nlz equal ``group_residues_ref``'s
    and are views of one buffer, whose residue block is the payload in
    stream order: group by group, son by son, (lo, hi) at width 64;
    the lo words, then the hi words, at widths 32 and 16."""
    words = port(groups(g, width, seed=g)[0])
    got = codec.encode_groups(*words, 4, width)
    want = ref.group_residues_ref(*words, 4, width)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    block = ops.codec.encode_block(*words, 4, width)
    assert block.shape == (2 * S * g + g,) and block.dtype == torch.int32
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    res_hi, res_lo, nlz = want
    if width == 64:
        stream = torch.stack([res_lo.T, res_hi.T], 2).reshape(-1)
    else:
        stream = torch.cat([res_lo.T.reshape(-1), res_hi.T.reshape(-1)])
    assert torch.equal(block, torch.cat([stream, nlz]))
    assert torch.equal(block, ref.group_residues_block_ref(*words, 4, width))


@pytest.mark.parametrize("seed", [0, 7])
def test_tree_field_stream(seed):
    """A Sedov tree field through compress_bits is the level-fused HDep
    stream that ``encode_tree_field`` writes."""
    rng = np.random.default_rng(seed)
    tree = amrgen.generate_tree(fields.sedov(r_shock=0.2 + 0.1 * rng.random()),
                                min_level=2, max_level=5, threshold=1.2)
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    pred, sons, _ = fpdelta._tree_groups(tree, tree.fields["density"])
    ph, plo = ops.f64_bits(torch.from_numpy(pred))
    sh, slo = ops.f64_bits(torch.from_numpy(sons))
    args = [t.T.contiguous() for t in (ph[:, None].expand(-1, S),
                                       plo[:, None].expand(-1, S), sh, slo)]
    got = ops.compress_bits(*args)
    stream = fpdelta.encode_tree_field(tree, "density").stream
    np.testing.assert_array_equal(cut(*got)[0], stream.codes)
    np.testing.assert_array_equal(cut(*got)[1], stream.payload)


# ---------------------------------------------------------- bit helpers

_F64_SPECIAL = np.concatenate([
    [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, 1e-310,
     3e38, 1e39, -1e39, 65504.0, 1 + 2**-8, 1 + 2**-8 + 2**-30, -2.5],
    np.array([0x7FF0000000000001, 0x7FF4000000000000, 0xFFF4000000000ABC,
              0xFFFFFFFFFFFFFFF0, 0x7FF00000E0000000],
             np.uint64).view(np.float64)])
_F32_SPECIAL = np.array(
    [0x7F800001, 0xFF800001, 0x7FA00000, 0x7FFFFFFF, 0x00000001, 0x807FFFFF,
     0x00400000, 0x7F7FFFFF, 0x3F808000, 0x3F818000, 0x3F808001, 0x7F7F8000,
     0x80000000, 0, 0x7F800000, 0xFF800000], np.uint32).view(np.float32)


@pytest.mark.parametrize("fn", ["f32_bits", "bf16_bits"])
@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_float_bits_vs_reference_on_special_values(fn, kind):
    """NaN payloads, ±0, subnormal inputs, ±inf, overflow and the
    double-rounding tie 1 + 2^-8 + 2^-30, bit for bit."""
    x = _F64_SPECIAL if kind == "float64" else _F32_SPECIAL
    with jax.enable_x64(True):
        want = np.asarray(getattr(ops_ref, fn)(jnp.asarray(x)))
    got = getattr(ops, fn)(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)


def test_float_bits_keep_float32_subnormals_as_the_host_codec():
    """A float64 whose float32 rounding is subnormal keeps it, as numpy
    and both packages' host codecs do (XLA on the CPU flushes it)."""
    x = np.array([1e-40, -1e-40, 1.2e-38, 1e-45, -3e-39])
    np.testing.assert_array_equal(u32(ops.f32_bits(torch.from_numpy(x))),
                                  x.astype(np.float32).view(np.uint32))
    f32 = x.astype(np.float32).view(np.uint32).astype(np.int64)
    rne = (f32 + 0x7FFF + ((f32 >> 16) & 1)) >> 16
    np.testing.assert_array_equal(u32(ops.bf16_bits(torch.from_numpy(x))),
                                  rne)


def test_bit_helpers_invert():
    w = np.array([0x7FC0, 0xFFFF, 0x7F81, 1, 0x8000, 0x12345678, 0xFFFFFFFF],
                 np.uint32)
    with jax.enable_x64(True):
        bf = np.asarray(ops_ref.bits_bf16(jnp.asarray(w))).view(np.uint16)
        f32 = np.asarray(ops_ref.bits_f32(jnp.asarray(w))).view(np.uint32)
    t = torch.from_numpy(w.view(np.int32))
    np.testing.assert_array_equal(
        ops.bits_bf16(t).view(torch.int16).numpy().view(np.uint16), bf)
    np.testing.assert_array_equal(ops.bits_f32(t).numpy().view(np.uint32),
                                  f32)
    np.testing.assert_array_equal(ops.bits_f32(torch.from_numpy(w)).numpy()
                                  .view(np.uint32), f32)   # uint32 words too
    x = torch.from_numpy(_F64_SPECIAL)
    hi, lo = ops.f64_bits(x)
    ref_hi, ref_lo = bs_ref.f64_to_pair(_F64_SPECIAL)
    np.testing.assert_array_equal(u32(hi), ref_hi)
    np.testing.assert_array_equal(u32(lo), ref_lo)


# ------------------------------------------------------ backends, counters

def test_cuda_backend_on_cpu_tensors_raises():
    words = port(groups(16, 64, seed=1)[0])
    calls = [
        lambda: ops.encode_groups_bits(*words, backend="cuda"),
        lambda: ops.decode_groups_bits(*words, backend="cuda"),
        lambda: ops.compress_bits(*words, backend="cuda"),
        lambda: ops.bitfield_pack(torch.ones(40, dtype=torch.bool),
                                  backend="cuda"),
        lambda: ops.bitfield_unpack(torch.ones(2, dtype=torch.int32), 40,
                                    backend="cuda"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="backend"):
        ops.encode_groups_bits(*words, backend="pallas")
    with pytest.raises(TypeError, match="int32 or uint32"):
        ops.encode_groups_bits(*[w.to(torch.int64) for w in words])


def test_wrappers_on_cpu_run_the_twins_and_count_nothing():
    words = port(groups(100, 64, seed=3)[0])
    before = dict(codec.LAUNCHES)
    got = codec.encode_groups(*words, 4, 64)
    want = ref.group_residues_ref(*words, 4, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ones = torch.ones(33, dtype=torch.uint8)
    assert torch.equal(codec.bitunpack(codec.bitpack(ones), 33), ones)
    assert codec.LAUNCHES == before
    with pytest.raises(ValueError, match="width"):
        codec.encode_groups(*words, 4, 48)


def test_library_named_by_every_source(tmp_path, monkeypatch):
    """One library over all of ``csrc/*.cu``; editing any source renames
    it, so a stale build is never loaded."""
    names = [p.name for p in cudalib.sources()]
    assert names == ["codec.cu", "raster.cu"]
    for p in cudalib.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(cudalib, "CSRC", tmp_path)
    first = cudalib.library_name()
    assert first.startswith("librepro_torch-") and first.endswith(".so")
    (tmp_path / "codec.cu").write_bytes(b"// edited\n" +
                                        (tmp_path / "codec.cu").read_bytes())
    assert cudalib.library_name() != first


# ------------------------------------------------------ the C interface

#: C argument types of the library's entries -> their ctypes; a pointer is
#: c_void_p (an int argtype would cut it to 32 bits)
C_TYPES = {"int32_t": ctypes.c_int32, "int": ctypes.c_int32,
           "int64_t": ctypes.c_int64, "float": ctypes.c_float,
           "double": ctypes.c_double}


def c_prototypes(src) -> dict:
    """Name -> ctypes argument types of every ``extern "C"`` entry that
    ``src`` defines."""
    text = src.read_text()
    out = {}
    for name, args in re.findall(r"^int\s+(\w+)\(([^)]*)\)\s*\{",
                                 text[text.index('extern "C" {'):], re.M):
        decls = [" ".join(a.split()) for a in args.split(",")]
        out[name] = [ctypes.c_void_p if "*" in d else
                     C_TYPES[d.rsplit(" ", 1)[0].removeprefix("const ")]
                     for d in decls]
    return out


@pytest.mark.parametrize("source", ["codec.cu", "raster.cu"])
def test_c_prototypes_match_signatures(source):
    """Every entry of the source has ``cudalib.SIGNATURES``' argument
    count and, per argument, its pointer or integer width; each ends with
    the device index and the stream."""
    protos = c_prototypes(cudalib.CSRC / source)
    assert protos
    for name, types in protos.items():
        assert cudalib.SIGNATURES.get(name) == types, name
        assert types[-2:] == [ctypes.c_int32, ctypes.c_void_p], name
    if source == "raster.cu":
        # B3-B5's float32 entries; B4's slice position crosses in the
        # value type: a C float (rounded by the caller) or a double
        for name in ("raster_slice_carry_f32", "raster_projection_carry_f32",
                     "raster_level_hist_f32"):
            assert name in protos, name
            assert protos[name] == protos[name.replace("_f32", "_f64")] \
                or name == "raster_slice_carry_f32", name
        assert protos["raster_slice_carry_f32"][9] == ctypes.c_float
        assert protos["raster_slice_carry_f64"][9] == ctypes.c_double
        # B1 takes B4's raw columns: the strided c_axis with its element
        # stride, and the position as a double
        b1 = protos["raster_slice_f64"]
        assert b1[2] == ctypes.c_int64 and b1[9] == ctypes.c_double
        assert b1[:10] == protos["raster_slice_carry_f64"][:10]
    else:
        # B6 writes one buffer: four word inputs, four ints, one output
        assert protos["codec_encode_groups"][:9] == \
            [ctypes.c_void_p] * 4 + [ctypes.c_int32, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_void_p]


def test_every_signature_has_a_c_entry():
    protos = {}
    for src in cudalib.sources():
        protos.update(c_prototypes(src))
    assert sorted(protos) == sorted(cudalib.SIGNATURES)


def test_launch_appends_device_and_stream_and_raises_on_error(monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return args[0]                # the "error" is the first argument

    monkeypatch.setitem(cudalib._FNS, "codec_bitpack", entry)
    monkeypatch.setattr(cudalib, "current_stream", lambda dev: 1000 + dev)
    cudalib.launch("codec_bitpack", 3, 0, 40, 77)
    assert calls == [(0, 40, 77, 3, 1003)]
    with pytest.raises(RuntimeError, match="codec_bitpack failed: "
                                           "cudaError 9"):
        cudalib.launch("codec_bitpack", 1, 9, 40, 77)


def test_device_index_and_word_checks():
    a = torch.zeros(3, dtype=torch.int32)
    assert cudalib.device_index(a, a.to(torch.bool)) == -1
    meta = torch.empty(3, dtype=torch.int32, device="meta")
    for ts in ((a, meta), (meta, a)):
        with pytest.raises(ValueError, match="one CUDA device or all on"):
            cudalib.device_index(*ts)
    assert cudalib.dense(a) is a
    assert cudalib.dense(a[::2]).is_contiguous()
    with pytest.raises(TypeError, match="int32 word tensors"):
        codec.decode_groups(a, a, a, a.to(torch.int64))
    with pytest.raises(ValueError, match="differ in shape"):
        codec.decode_groups(a, a, a, a[:2])


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 32, 16])
def test_cuda_codec_kernels_bit_equal_to_twins(cuda_device, width):
    words = [w.to(cuda_device) for w in port(groups(5000, width, 11)[0])]
    for zbits in (2, 4, 8):
        got = codec.encode_groups(*words, zbits, width)
        want = ref.group_residues_ref(*words, zbits, width)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    dec = codec.decode_groups(got[0], got[1], words[0], words[1])
    assert torch.equal(dec[0], words[2]) and torch.equal(dec[1], words[3])
    # one (2, S, G) allocation: the son words are its two halves
    assert dec[0].untyped_storage().data_ptr() == \
        dec[1].untyped_storage().data_ptr()
    assert dec[1].data_ptr() - dec[0].data_ptr() == 4 * dec[0].numel()
    odd = [w.reshape(-1)[1:] for w in (got[0], got[1], words[0], words[1])]
    assert all(torch.equal(a, b) for a, b in
               zip(codec.decode_groups(*odd), ref.decode_residues_ref(*odd)))
    for n in (1, 31, 32, 1000, 32 * 1024 + 17):
        flags = torch.rand(n, device=cuda_device) < 0.4
        packed = codec.bitpack(flags)
        assert torch.equal(packed, ref.bitpack_ref(flags))
        assert torch.equal(codec.bitunpack(packed, n),
                           ref.bitunpack_ref(packed, n))
        assert torch.equal(codec.bitunpack(packed, n).bool(), flags)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 32, 16])
def test_cuda_encode_groups_views_of_one_buffer(cuda_device, width):
    """On the card B6's three outputs are views of one allocation, equal
    to the twin's (S, G) residues and nlz, and its block equals the
    twin's stream-ordered block, with 16-byte stores (S = 8) and
    without (S = 3)."""
    for s_, g in ((S, 5000), (3, 777)):
        words = [w.to(cuda_device) for w in
                 port(groups(g, width, 13)[0])]
        if s_ != S:
            words = [w[:s_].contiguous() for w in words]
        for zbits in (2, 4, 8):
            got = codec.encode_groups(*words, zbits, width)
            want = ref.group_residues_ref(*words, zbits, width)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert len({t.untyped_storage().data_ptr() for t in got}) == 1
            assert torch.equal(
                codec.encode_block(*words, zbits, width),
                ref.group_residues_block_ref(*words, zbits, width))
    torch.cuda.synchronize()
