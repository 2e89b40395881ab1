"""K12b's tiles and index maps (csrc/probe_precision.cu), on the CPU.

The tensor-core modes run on ``wgmma`` over operands staged in shared
memory: A's rows by bulk copies into padded rows, each thread's register
fragment read from them and rounded (split) with ``cvt.rna``; B loaded,
rounded (split) and stored transposed in the 128-byte-swizzled K-major
layout that its shared-memory descriptor names.  ffma runs 2 x 2 outputs a
thread.  The CUDA code has no CPU mode, so these tests parse the tile
constants and the index maps from the source (``b_swz``, ``b_stage_k`` /
``b_stage_q``, ``b_desc``, ``b_kstep_off``, ``a_frag_*``, ``acc_*``,
``fm_*``, the shared-memory sizes) and replay them in NumPy against an
independent model of what the hardware reads (PTX ISA: the K-major
canonical layout with the 128-byte swizzle, address bits 4-6 XOR bits 7-9;
the m64nNk8 .tf32 register-A fragment and the m64nN f32 accumulator):

  - the staging pass writes every element of B's tile once, onto a
    bijection of its words, each warp's stores in 32 banks; what the
    descriptor makes ``wgmma`` read at every k-step is B's element (n, k);
  - the A fragment and the accumulator maps cover their tiles once, the
    fragment loads in 32 banks;
  - the emulated kernel (each cluster block's slice of the depth, its pass
    order lo*hi, hi*lo, hi*hi, f32 accumulation, the partial tiles added
    in rank order through ``red_slot``'s one-to-one slots) equals
    ``probe_dot_plain`` within 1e-5 of the peak on seeded random inputs,
    and reads 256.0625 / 256.0 / 256.0625 on the probe input; the emulated
    ffma (k in order) within 1e-6;
  - ``build.parse_sass`` splits ``cuobjdump -sass`` by function, as
    chip_smoke.py's HGMMA check reads it.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch.kernels import probe_precision as K12b

torch.set_num_threads(2)

SOURCE = (Path(K12b.__file__).resolve().parent.parent / "csrc"
          / "probe_precision.cu")
SMEM_MAX = 232448          # bytes of shared memory a block can use (H100)
SMEM_BASE = 0x2400         # a 1 KB-aligned shared address of the B tile


@functools.lru_cache(maxsize=None)
def consts() -> dict:
    src = SOURCE.read_text()
    out = {m[1]: int(m[2]) for m in re.finditer(
        r"^#define (\w+) (\d+)\b", src, re.M)}
    pad = int(re.search(r"#define A_LD\(K\) \(\(K\) \+ (\d+)\)", src)[1])
    out["A_LD"] = lambda k: k + pad
    out["FM_THREADS"] = (out["FM_BM"] // 2) * (out["FM_BN"] // 2)
    return out


def c_fn(name: str):
    """The source's one-line ``name(...) { return expr; }`` as a Python
    function (casts dropped, ``/`` as ``//``: the arguments are
    non-negative ints)."""
    m = re.search(name + r"\(([^)]*)\)\s*\{\s*return ([^;]+);",
                  SOURCE.read_text(), re.S)
    args = [a.split()[-1] for a in m[1].split(",")]
    expr = re.sub(r"\((?:uint64_t|uint32_t|unsigned|int)\)", "", m[2])
    expr = " ".join(expr.replace("/", "//").split())
    code = compile(expr, name, "eval")
    return lambda *v: eval(code, dict(consts()), dict(zip(args, v)))


def tf32_bits(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 of finite f32 values, as their f32 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.uint32)


def as_f32(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


def test_tile_constants_match_the_wrapper():
    c = consts()
    assert (32 * c["TC_SPLIT"], c["PD_KMAX"], c["TC_N"]) == (
        K12b.K_MULT, K12b.K_MAX, K12b.N_TILE)
    assert K12b.K_MULT % c["PD_KS"] == 0        # ffma's whole groups
    assert c["FM_BN"] == K12b.N_TILE
    assert K12b.M_TILE == {"ffma": c["FM_BM"], "tf32": c["TC_M"],
                           "3xtf32": c["TC_M"]}
    assert c["TC_THREADS"] == 128 and c["TC_M"] == 64   # one warpgroup
    ks = c["PD_KMAX"] // c["TC_SPLIT"]
    for three in (0, 1):
        # B hi (and lo), A's padded rows, the other blocks' partial tiles,
        # 1 KB to align B: within a block's shared memory at the deepest K
        want = (1024 + (1 + three) * ks * c["TC_N"] * 4
                + c["TC_M"] * c["A_LD"](ks) * 4
                + (c["TC_SPLIT"] - 1) * 128 * c["TC_N"] // 2 * 4)
        assert c_fn("tc_smem")(three, ks) == want <= SMEM_MAX
    assert c_fn("fm_smem")(c["PD_KMAX"]) == 4 * (
        c["FM_BM"] * c["A_LD"](c["PD_KMAX"]) + c["PD_KMAX"] * c["FM_BN"])
    # the partial tiles' slots in block 0: one a (block, element, thread)
    r, i, t = np.meshgrid(np.arange(1, c["TC_SPLIT"]),
                          np.arange(c["TC_N"] // 2), np.arange(128),
                          indexing="ij")
    slots = np.sort(c_fn("red_slot")(r, i, t).ravel())
    np.testing.assert_array_equal(slots, np.arange(slots.size))


@pytest.mark.parametrize("k", [32, 64, 128])
def test_staged_b_is_a_bijection_read_back_by_the_descriptor(k):
    """k: a block's depth slice."""
    c = consts()
    b_swz, sk, sq = c_fn("b_swz"), c_fn("b_stage_k"), c_fn("b_stage_q")
    tid = np.arange(c["TC_THREADS"])
    seen = np.zeros((c["TC_N"], k), int)
    words = np.zeros(k * c["TC_N"], int)
    for j in range(k // 32):
        for e in range(4):
            n, kk = 4 * sq(tid) + e, 32 * j + sk(tid)
            np.add.at(seen, (n, kk), 1)
            off = b_swz(n, kk)
            assert np.all(off % 4 == 0)
            np.add.at(words, off // 4, 1)
            for w in range(4):      # one store instruction of a warp
                banks = (off[32 * w:32 * w + 32] // 4) % 32
                assert len(set(banks.tolist())) == 32, (j, e, w)
    assert np.all(seen == 1) and np.all(words == 1)

    b_desc, kstep = c_fn("b_desc"), c_fn("b_kstep_off")
    n = np.arange(c["TC_N"])[:, None]
    kk = np.arange(8)[None, :]
    for ks in range(k // 8):
        desc = b_desc(SMEM_BASE + kstep(ks))
        assert (desc >> 62) & 3 == 1               # 128-byte swizzle
        assert (desc >> 49) & 7 == 0               # base offset
        start = (desc & 0x3FFF) << 4
        sbo = ((desc >> 32) & 0x3FFF) << 4
        addr = start + (n // 8) * sbo + (n % 8) * 128 + kk * 4
        addr = addr ^ (((addr >> 7) & 7) << 4)
        np.testing.assert_array_equal(addr - SMEM_BASE,
                                      b_swz(n, 8 * ks + kk))


def hw_a(w, lane, i):
    """(row, column) of register i of warp w's lane in the m64nNk8 .tf32
    A fragment (PTX ISA)."""
    return 16 * w + lane // 4 + 8 * (i % 2), lane % 4 + 4 * (i // 2)


def hw_acc(w, lane, i):
    """(row, column) of accumulator register i of an m64nN f32 tile."""
    return (16 * w + lane // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (lane % 4) + i % 2)


WLI = np.meshgrid(np.arange(4), np.arange(32), np.arange(4), indexing="ij")


def test_fragment_maps_cover_their_tiles_once():
    c = consts()
    w, lane, i = WLI
    r, col = c_fn("a_frag_row")(w, lane, i), c_fn("a_frag_col")(lane, i)
    tile = np.zeros((64, 8), int)
    np.add.at(tile, (r, col), 1)
    assert np.all(tile == 1)
    k = 256
    for ii in range(4):     # one fragment load of a warp: 32 banks
        banks = (r[0, :, ii] * c["A_LD"](k) + col[0, :, ii]) % 32
        assert len(set(banks.tolist())) == 32
    w, lane, i = np.meshgrid(np.arange(4), np.arange(32),
                             np.arange(c["TC_N"] // 2), indexing="ij")
    out = np.zeros((64, c["TC_N"]), int)
    np.add.at(out, (c_fn("acc_row")(w, lane, i), c_fn("acc_col")(lane, i)),
              1)
    assert np.all(out == 1)


def emulate_wgmma(a: np.ndarray, b: np.ndarray, three: bool) -> np.ndarray:
    """The tensor-core kernel on the CPU: each cluster block's slice staged
    by its maps, the hardware's reads by the model above, f32 accumulation
    a wgmma, the partial tiles added in rank order."""
    c = consts()
    m_, k = a.shape
    n_ = b.shape[1]
    split = c["TC_SPLIT"]
    ks = k // split
    tn, ld = c["TC_N"], c["A_LD"](ks)
    b_swz, sk, sq = c_fn("b_swz"), c_fn("b_stage_k"), c_fn("b_stage_q")
    b_desc, kstep = c_fn("b_desc"), c_fn("b_kstep_off")
    a_r, a_c = c_fn("a_frag_row"), c_fn("a_frag_col")
    acc_r, acc_c = c_fn("acc_row"), c_fn("acc_col")
    w, lane, i = WLI
    hr, hc = hw_a(w, lane, i)
    tid = np.arange(c["TC_THREADS"])
    nb = np.arange(tn)[:, None]
    kb = np.arange(8)[None, :]
    passes = ((("lo", "hi"), ("hi", "lo")) if three else ()) + (("hi", "hi"),)
    wv, lv, iv = np.meshgrid(np.arange(4), np.arange(32), np.arange(tn // 2),
                             indexing="ij")
    rr, cc = hw_acc(wv, lv, iv)
    out = np.full((m_, n_), np.nan, np.float32)
    for m0 in range(0, m_, 64):
        for n0 in range(0, n_, tn):
            tile = None
            for rank in range(split):
                k0 = rank * ks
                sa = np.full((64, ld), np.nan, np.float32)
                sa[:, :ks] = a[m0:m0 + 64, k0:k0 + ks]   # the async copies
                smem = {p: np.zeros(ks * tn, np.uint32) for p in ("hi", "lo")}
                for j in range(ks // 32):
                    for e in range(4):
                        kk, nn = 32 * j + sk(tid), 4 * sq(tid) + e
                        x = b[k0 + kk, n0 + nn]
                        hi = tf32_bits(x)
                        smem["hi"][b_swz(nn, kk) // 4] = hi
                        smem["lo"][b_swz(nn, kk) // 4] = tf32_bits(
                            x - as_f32(hi))
                d = np.zeros((64, tn), np.float32)
                for s in range(ks // 8):
                    x = sa[a_r(w, lane, i), 8 * s + a_c(lane, i)]
                    regs = {"hi": tf32_bits(x)}
                    regs["lo"] = tf32_bits(x - as_f32(regs["hi"]))
                    desc = b_desc(SMEM_BASE + kstep(s))
                    start = (desc & 0x3FFF) << 4
                    sbo = ((desc >> 32) & 0x3FFF) << 4
                    addr = start + (nb // 8) * sbo + (nb % 8) * 128 + kb * 4
                    addr = addr ^ (((addr >> 7) & 7) << 4)
                    for pa, pb in passes:
                        at = np.full((64, 8), np.nan, np.float32)
                        at[hr, hc] = as_f32(regs[pa])
                        bt = as_f32(smem[pb][(addr - SMEM_BASE) // 4])
                        d = (d.astype(np.float64) + at.astype(np.float64)
                             @ bt.T.astype(np.float64)).astype(np.float32)
                # the registers of rank's block, added in block 0 in order
                regs_d = d[rr, cc]
                tile = regs_d if tile is None else tile + regs_d
            out[m0 + acc_r(wv, lv, iv), n0 + acc_c(lv, iv)] = tile
    return out


def emulate_ffma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    c = consts()
    m_, k = a.shape
    n_ = b.shape[1]
    tid = np.arange(c["FM_THREADS"])
    r0, c0 = c_fn("fm_row")(tid), c_fn("fm_col")(tid)
    out = np.full((m_, n_), np.nan, np.float32)
    for m0 in range(0, m_, c["FM_BM"]):
        for n0 in range(0, n_, c["FM_BN"]):
            rows = m0 + r0[:, None] + np.array([0, 0, 1, 1])
            cols = n0 + c0[:, None] + np.array([0, 1, 0, 1])
            acc = np.zeros(rows.shape, np.float32)
            for kk in range(k):     # fmaf in k's order
                acc = (a[rows, kk].astype(np.float64) * b[kk, cols]
                       + acc).astype(np.float32)
            out[rows, cols] = acc
    return out


def emulate(a, b, mode):
    return (emulate_ffma(a, b) if mode == "ffma"
            else emulate_wgmma(a, b, mode == "3xtf32"))


@pytest.mark.parametrize("mode", K12b.MODES)
def test_emulated_kernel_matches_plain(mode):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((128, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    got = emulate(a, b, mode)
    want = K12b.probe_dot_plain(torch.from_numpy(a), torch.from_numpy(b),
                                mode).double().numpy()
    tol = 1e-6 if mode == "ffma" else 1e-5
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))
    pa, pb = (t.numpy() for t in K12b.probe_inputs("cpu"))
    reading = emulate(pa, pb, mode)
    want = {"ffma": K12b.EXACT, "tf32": K12b.ROUNDED, "3xtf32": K12b.EXACT}
    assert np.all(reading == want[mode])


def test_parse_sass_splits_the_functions():
    """chip_smoke.py's HGMMA check reads cuobjdump -sass by function."""
    from sdr_pmr446_tpu_torch.kernels import build
    text = """
Fatbin elf code:
================
arch = sm_90a
\tcode for sm_90a
\t\tFunction : _Z11probe_wgmmaILb1EEvPKfS1_Pfii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0400*/                   HGMMA.64x16x8.F32.TF32 R24, R88, gdesc[UR4], R24 ;
\t\t..........
\t\tFunction : _Z10probe_ffmaPKfS0_Pfii
        /*0100*/                   FFMA R5, R6, R7, R5 ;
"""
    funcs = build.parse_sass(text)
    assert list(funcs) == ["_Z11probe_wgmmaILb1EEvPKfS1_Pfii",
                           "_Z10probe_ffmaPKfS0_Pfii"]
    assert "HGMMA" in funcs["_Z11probe_wgmmaILb1EEvPKfS1_Pfii"]
    assert "HGMMA" not in funcs["_Z10probe_ffmaPKfS0_Pfii"]
