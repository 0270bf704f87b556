"""Where the time of the bf16 attention forward goes on the card
(`csrc/flash_fwd_sm90.cu`: K2 `flash_online` and K3 `flash_static_max` at
4096 keys, K1 `flash_small_kv` at the caption's 256 and 32, and the
class-conditional and Flag-DiT shapes at head_dim 48, 96 and 128).

    python -m lumina_t2x_tpu_torch.exps.fwd_sm90_breakdown [--shapes NAME ...]
        [--blocks | --chain]

Builds variants of the kernel's source, each with one part taken out, and
times each (static bound 16.14 and online, bf16, every key valid) at the
shapes named (`SHAPES`, default `2b`), beside one
`scaled_dot_product_attention` call on the same inputs:

  2b          the 2B's query shape (B=2, Sq=4096, H=32, D=72) for each key
              length of its main path (the self-attention's 4096, the
              sampler's 256 caption tokens, the served worker's and the
              trainer's 32)
  2b_gemma    the same over the Gemma caption lengths 8, 40 and 136
  2b_128k     (1, 131072, 32, 72), Sk = 256: the 128K-token forward's captions
  small       (128, 1024, 8, 48), Sk = 1024: the Small's sampler (K1)
  600m        (8, 256, 32, 48), Sk = 256: the ImageNet 600M's sampler (K1)
  600m_train  (256, 256, 32, 48), Sk = 256: the 600M's trainer (K4's kernel)
  7b          (8, 256, 32, 128), Sk = 256: the ImageNet 7B's sampler (K1)
  5b          (2, 4160, 32, 96), Sk = 4160: the Flag-DiT 5B (K2-K5)
  mmdit_db    (2, 589, 24, 64), Sk = 589: MMDiT's joint sequence in
              DreamBooth at 256^2 (K4's kernel)
  music_train (32, 256, 16, 72), Sk = 256 and 77: the music trainer (K4's)
  2b_db       (2, 256, 32, 72), Sk = 256: the 2B's DreamBooth at 256^2 (K4's)
  audio       (2, 128, 16, 72), Sk = 128 and 16: FlagDiT-1D's bf16 forward (K1)
  sd3         (2, 4429, 24, 64), Sk = 4429: MMDiT-SD3-Medium's joint sequence at
              1024^2 (K2-K4 on 64/64 over more than 1024 keys)

At key lengths up to 1024 it also times K1 itself: `flash_small_kv` by CUDA
events around the wrapper, and its kernel's device time under
`torch.profiler` (the difference is the wrapper's host time). The variants:

  kernel         the source as it is
  loads only     the consumers skip the products and the chain: what the
                 TMA ring and the barriers alone take
  compute only   the producer loads Q but no K/V tile (it arrives on each
                 stage's barrier at once): the products and the chain on
                 whatever the ring holds
  products only  compute only, without the chain: the tensor-core work
  P once         P rounded once to bf16: no lo product, no second pack

With `--blocks` it times instead, at each shape, every block of `BLOCKS`
(depth/width, consumer warpgroups of 64 rows, blocks built to be resident
an SM, and the K/V-resident block's Q tiles a block: fixed, or set at
launch; over at most 256 keys) at the width the kernel picks and at the
width head_dim took before 48/48 and 96/96 (64/64, 128/128), the one
`launch()` picks marked: the
source with `launch()` forced to one block at a time, each computing the
function, by CUDA events and by its device time under `torch.profiler`.
With `--chain` it times the variants of `_CHAIN` instead: the online
chain's row max in four chains, o scaled only when a row's max moved, both,
the scale folded into the exp's FMA, the consumers issuing without turns,
and S(j + 1) issued as soon as PV(j - 1) is done into a second set of S
registers, each beside the kernel as it is.

Only "kernel" (and `--blocks`, and `--chain`'s variants) computes the
function; the others are timings. Each variant
is compiled with nvcc into `build/fwd_sm90_breakdown/` from the source with
`sm90_common.cuh` pasted in (the K/V ring's producer and the pair product
live there); the edits are checked, so a changed kernel fails here instead
of timing something else. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import torch

from ..ops import cuda_lib
from ..ops import flash_attention as fa
from . import device_label, device_ms, source_with_common, time_ms

# name: ((B, Sq, H, D), key lengths)
SHAPES = {
    # self-attention, sampler captions, served / trainer captions
    "2b": ((2, 4096, 32, 72), (4096, 256, 32)),
    # the 2B trainer's Gemma caption lengths; the 128K-token forward's captions
    "2b_gemma": ((2, 4096, 32, 72), (8, 40, 136)),
    "2b_128k": ((1, 131072, 32, 72), (256,)),
    "small": ((128, 1024, 8, 48), (1024,)),
    "600m": ((8, 256, 32, 48), (256,)),
    "600m_train": ((256, 256, 32, 48), (256,)),
    "7b": ((8, 256, 32, 128), (256,)),
    "5b": ((2, 4160, 32, 96), (4160,)),
    "mmdit_db": ((2, 589, 24, 64), (589,)),
    "music_train": ((32, 256, 16, 72), (256, 77)),
    "2b_db": ((2, 256, 32, 72), (256,)),
    "audio": ((2, 128, 16, 72), (128, 16)),
    "sd3": ((2, 4429, 24, 64), (4429,)),
}
BOUND = 16.14
SOURCE = cuda_lib._CSRC / "flash_fwd_sm90.cu"
_BUILD = cuda_lib._BUILD_ROOT.parent / "fwd_sm90_breakdown"

# the parts of the source a variant takes out (each must occur once)
_LOOP_PRODUCTS = """      qk_tile<L, kDK, T>(s, q_addr, q_tail, base, st);
      wgmma_commit();
      pv_tile<L, kDN, T>(o, phi, plo, base, prev);
"""
_LOOP_EXP = "      exp_tile<T, kStaticMax>(s, bits[st], tid % 4, l, m, alpha, p);\n"
_LOOP_PACK = "      pack_tile<T, kStaticMax, kN>(s, alpha, o, phi, plo);\n"
# the same parts of the K/V-resident block's per-tile sequence (`attend_rows`)
_RES_PRODUCTS = _LOOP_PRODUCTS.replace("      ", "    ")
_RES_EXP = ("    pin(s);\n" + _LOOP_EXP.replace("      ", "    "))
_RES_PACK = ("    mbar_arrive(base + L::empty(prev));\n" + _LOOP_PACK.replace("      ", "    "))
_KV_LOADS = """      mbar_expect_tx(base + L::full(st), L::kStageBytes);
      for (int a = 0; a < L::kWideK; ++a)
        tma_load(base + L::k(st) + a * L::kAtom, tk, base + L::full(st), a * kAtomCols, hk, j0, b);
      if (L::kNarrow)
        tma_load(base + L::k_tail(st), tk_narrow, base + L::full(st), L::kWideK * kAtomCols, hk,
                 j0, b);
      for (int a = 0; a < L::kWideV; ++a)
        tma_load(base + L::v(st) + a * L::kAtom, tv, base + L::full(st), a * kAtomCols, hk, j0, b);
      if (L::kNarrow)
        tma_load(base + L::v_tail(st), tv_narrow, base + L::full(st), L::kWideV * kAtomCols, hk,
                 j0, b);
"""
_NO_KV = "      mbar_arrive(base + L::full(st));\n"
_LO_PRODUCT = "    wgmma_rs<kDN, T>(acc, lo[kk], desc);\n"
_LO_NARROW = ("    wgmma_rs_n<T>(wide, lo[kk], desc);\n"
              "    wgmma_rs_n<T>(tail, lo[kk], narrow);\n")
_LO_PACK = """    lo[n / 2][2 * (n % 2)] = E::pack(x[4 * n] - E::lo(top), x[4 * n + 1] - E::hi(top));
    lo[n / 2][2 * (n % 2) + 1] = E::pack(x[4 * n + 2] - E::lo(bot), x[4 * n + 3] - E::hi(bot));
"""
_EDITS = {
    "kernel": [],
    "loads only": [(_LOOP_PRODUCTS, ""), (_LOOP_EXP, ""), (_LOOP_PACK, ""), (_RES_PRODUCTS, ""),
                   (_RES_EXP, "    pin(s);\n"),
                   (_RES_PACK, "    mbar_arrive(base + L::empty(prev));\n")],
    "compute only": [(_KV_LOADS, _NO_KV)],
    "products only": [(_KV_LOADS, _NO_KV), (_LOOP_EXP, ""), (_LOOP_PACK, ""),
                      (_RES_EXP, "    pin(s);\n"),
                      (_RES_PACK, "    mbar_arrive(base + L::empty(prev));\n")],
    "P once": [(_LO_PRODUCT, ""), (_LO_NARROW, ""), (_LO_PACK, "")],
}
# `--chain`: changes to the online chain (every width's) and to the
# consumers' turns, each timed against the kernel as it is. The max of a
# row's logits in four chains of four instead of two of sixteen (max is
# exact in any order); o scaled only when a row's max moved in the warp (a
# multiply by 1 changes no bit); the scale folded into the exp's FMA (the
# max over the raw logits, times |scale|: one FMUL a logit less, other bits)
_SERIAL_MAX = "    float mx[2] = {-INFINITY, -INFINITY};\n"
_TREE_MAX = """    float mq[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) mq[r][0] = mq[r][1] = mq[r][2] = mq[r][3] = -INFINITY;
"""
_SERIAL_ACC = "        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);\n"
_TREE_ACC = ("        mq[(i >> 1) & 1][(i >> 2) & 3] = "
             "fmaxf(mq[(i >> 1) & 1][(i >> 2) & 3], s[i]);\n")
_SERIAL_END = """    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
"""
_TREE_END = """    float mx[2], shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(mq[r][0], mq[r][1]), fmaxf(mq[r][2], mq[r][3]));
"""
_SCALED = "        s[i] *= p.scale2;\n"
_MASKED = "        s[i] = key_valid(bits, i) ? s[i] * p.scale2 : -INFINITY;\n"
_TREE = [(_SERIAL_MAX, _TREE_MAX), (_SCALED + _SERIAL_ACC, _SCALED + _TREE_ACC),
         (_MASKED + _SERIAL_ACC, _MASKED + _TREE_ACC), (_SERIAL_END, _TREE_END)]
_ALWAYS_RESCALE = """  if (!kStaticMax ||
      (kIsF16<T> && __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))) {
"""
_MOVED_RESCALE = """  if ((!kStaticMax || kIsF16<T>) &&
      __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
"""
_ONLINE_MAX = """    if (all_valid) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        s[i] *= p.scale2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        s[i] = key_valid(bits, i) ? s[i] * p.scale2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
"""
_FOLDED_MAX = """    const bool neg = p.scale2 < 0.f;  // the max of -s then
    if (all_valid && !neg) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1],
                                 key_valid(bits, i) ? (neg ? -s[i] : s[i]) : -INFINITY);
    }
"""
_ONLINE_EXP = ("#pragma unroll\n    for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(s[i] - "
               "shift[(i >> 1) & 1]);  // masked: 0\n")
_FOLDED_EXP = """    if (all_valid) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(fmaf(s[i], p.scale2, -shift[(i >> 1) & 1]));
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float e = ex2(fmaf(s[i], p.scale2, -shift[(i >> 1) & 1]));
        s[i] = key_valid(bits, i) ? e : 0.f;
      }
    }
"""
_FOLD = [(_ONLINE_MAX, _FOLDED_MAX),
         ("      const float m_new = fmaxf(m[r], mx[r]);\n",
          "      const float m_new = fmaxf(m[r], mx[r] * fabsf(p.scale2));\n"),
         (_ONLINE_EXP, _FOLDED_EXP)]
_LOOP_HEAD = ("    for (int j = 1; j < nk; ++j) {\n"
              "      const int st = j % kStages, prev = (j - 1) % kStages;\n")
_LOOP_TAIL = ("      pack_tile<T, kStaticMax, kN>(s, alpha, o, phi, plo);\n    }\n\n"
              "    if (kTurns) bar_sync(mine);\n")
_EARLY_QK = """    constexpr bool kEarlyQk = kConsumers == 3 && kN <= 36;
    if constexpr (kEarlyQk) {
      // The same products and chain in the same order, S(j + 1) issued as
      // soon as PV(j - 1) is done, outside the turns, into a second set of
      // S registers: it is ready when the consumer's turn next comes, so the
      // chain of S(j + 1) waits for no product the other consumers issued.
      float s2[kBK / 2];
      const auto step = [&](float(&sc)[kBK / 2], float(&sn)[kBK / 2], int j) {
        const int prev = (j - 1) % kStages;
        if (kTurns) bar_sync(mine);
        pin(o);
        pin(phi);
        pin(plo);
        wgmma_fence();
        pv_tile<L, kDN, T>(o, phi, plo, base, prev);
        wgmma_commit();
        if (kTurns) bar_arrive(other);
        wgmma_wait<1>();
        pin(sc);
        exp_tile<T, kStaticMax>(sc, bits[j % kStages], tid % 4, l, m, alpha, p);
        wgmma_wait<0>();
        pin(o);
        mbar_arrive(base + L::empty(prev));
        if (j + 1 < nk) {
          const int nx = (j + 1) % kStages;
          mbar_wait(base + L::full(nx), ((j + 1) / kStages) & 1);
          wgmma_fence();
          qk_tile<L, kDK, T>(sn, q_addr, q_tail, base, nx);
          wgmma_commit();
          pin(sn);
        }
        pack_tile<T, kStaticMax, kN>(sc, alpha, o, phi, plo);
      };
      int j = 1;
      if (nk > 1) {
        mbar_wait(base + L::full(1), 0);
        wgmma_fence();
        qk_tile<L, kDK, T>(s2, q_addr, q_tail, base, 1);
        wgmma_commit();
        pin(s2);
      }
      for (; j + 1 < nk; j += 2) {
        step(s2, s, j);
        step(s, s2, j + 1);
      }
      if (j < nk) step(s2, s, j);
"""
_CHAIN = {
    "kernel": [],
    "tree max": _TREE,
    "moved rescale": [(_ALWAYS_RESCALE, _MOVED_RESCALE)],
    "tree + moved": [*_TREE, (_ALWAYS_RESCALE, _MOVED_RESCALE)],
    "scale in FMA": _FOLD,
    # the consumers issue their products when ready, not in turn
    "no turns": [("    constexpr bool kTurns = kConsumers > 1;\n",
                  "    constexpr bool kTurns = false;\n"),
                 ("  constexpr bool kTurns = kConsumers > 1;\n  const int mine",
                  "  constexpr bool kTurns = false;\n  const int mine")],
    # S(j + 1) issued once PV(j - 1) is done, into a second set of S
    # registers (192 rows, up to 80/72: the registers it needs fit)
    "early QK": [(_LOOP_HEAD, _EARLY_QK + "    } else {\n" + _LOOP_HEAD),
                 (_LOOP_TAIL, _LOOP_TAIL.replace("    }\n", "    }\n    }\n", 1))],
}
# each variant exports the launcher under a C name (bf16 K2/K3: no LSE, no rotation)
_ENTRY = """
extern "C" int breakdown_fwd(int static_max, const void* q, const void* k, const void* v,
                             const int* mask, void* out, const long long* meta, float scale,
                             float bound, void* stream) {
  return flash_fwd_sm90(false, static_max != 0, q, k, v, mask, out, nullptr, nullptr, nullptr,
                        meta, scale, bound, stream);
}
"""


# the blocks `--blocks` times: (depth, width, consumer warpgroups, blocks an
# SM, Q tiles), each one the kernel's `Block` and `KvRing` take; Q tiles != 0
# is the K/V-resident block (that many 64-row Q tiles of one head a block,
# -1 as many as `resident_split` gives the call; at most 256 keys; two an SM
# on narrow atoms), 0 a block of 64 rows a consumer
BLOCKS = ((48, 48, 3, 1, 0), (48, 48, 2, 1, 0), (48, 48, 1, 2, 0), (48, 48, 1, 3, 0),
          (48, 48, 2, 2, 0), (64, 64, 3, 1, 0), (64, 64, 2, 1, 0), (64, 64, 1, 3, 0),
          (80, 72, 3, 1, 0), (80, 72, 2, 1, 0), (80, 72, 1, 3, 0), (80, 72, 2, 1, -1),
          (80, 72, 2, 1, 8), (80, 72, 2, 1, 16), (80, 72, 2, 1, 32), (80, 72, 3, 1, 6),
          (80, 72, 1, 2, 8), (96, 96, 3, 1, 0), (96, 96, 2, 1, 0), (128, 128, 3, 1, 0),
          (128, 128, 2, 1, 0))
RESIDENT_KEYS = 256  # the K/V-resident block's most keys (its launch refuses more)
_LAUNCH = ("template <class T, bool kStaticMax>\nint launch(const Params& p, cudaStream_t stream) "
           "{\n  return by_shape(")


def kernel_source() -> str:
    """The kernel's source with the shared header pasted in: what the variants edit."""
    return source_with_common(SOURCE)


def variant_source(name: str, source: str, edits=None) -> str:
    """The kernel's source (`kernel_source()`) with variant `name`'s parts
    taken out (or, from `_CHAIN`, its chain changed)."""
    for old, new in (edits or _EDITS)[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the kernel source changed; update its edits")
        source = source.replace(old, new)
    return source + _ENTRY


def blocks_source(source: str) -> str:
    """The kernel's source (`kernel_source()`) with `launch()` running the
    block of `BLOCKS` that the entry `breakdown_block(i)` names (-1:
    `by_shape`'s, as the kernel picks)."""
    if source.count(_LAUNCH) != 1:
        raise RuntimeError("blocks: the kernel source changed; update _LAUNCH")
    cases = "\n".join(f"    case {i}: return fn(Dims<{a}, {b}, {c}, {d}, {t}>{{}});"
                      for i, (a, b, c, d, t) in enumerate(BLOCKS))
    pick = ("int g_block = -1;\ntemplate <class Fn>\nint by_block(int d, int sq, int sk, Fn fn) {\n"
            f"  switch (g_block) {{\n{cases}\n  }}\n  return by_shape(d, sq, sk, fn);\n}}\n\n")
    source = source.replace(_LAUNCH, pick + _LAUNCH.replace("by_shape(", "by_block("))
    attrs = "\n".join(f"    case {i}: return attributes_dims<bf16, false, {a}, {b}, {c}, {d}, "
                      f"{t}>(out);" for i, (a, b, c, d, t) in enumerate(BLOCKS))
    return (source + _ENTRY + 'extern "C" void breakdown_block(int i) { g_block = i; }\n'
            'extern "C" int breakdown_block_attributes(int i, long long* out) {\n'
            f"  switch (i) {{\n{attrs}\n  }}\n  return 1;\n}}\n")


def build(texts: dict) -> dict:
    """{name: ctypes library} of {name: source}, compiled in parallel (once
    per source)."""
    jobs = {}
    for name, text in texts.items():
        out = _BUILD / hashlib.sha256(text.encode()).hexdigest()[:16] / "libvariant.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            (out.parent / "variant.cu").write_text(text)
            flags = [f for f in cuda_lib._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            jobs[name] = (out, subprocess.Popen(
                [cuda_lib.nvcc(), *flags, "-shared", "-I", str(cuda_lib._CSRC), "-o", str(out),
                 str(out.parent / "variant.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        else:
            jobs[name] = (out, None)
    libs = {}
    for name, (out, proc) in jobs.items():
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on variant {name!r}:\n{err}")
        lib = ctypes.CDLL(str(out))
        lib.breakdown_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.breakdown_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, static_max, q, k, v, out, meta, scale, device, name):
    err = lib.breakdown_fwd(int(static_max), q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                            out.data_ptr(), meta, scale, BOUND,
                            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: cudaError {err}")


def _dev(ms):
    return "not traced" if ms is None else f"{ms:.4f} ms"


def time_blocks(lib, device, shape, sks):
    """Prints each block of `BLOCKS` at the width the kernel picks for this
    head_dim and at the width it took before, static max and online."""
    b, s, h, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device=device).to(torch.bfloat16)
    out = torch.empty_like(q)
    scale = d ** -0.5
    before = 64 if d <= 64 else 72 if d <= 72 else 128
    for sk in sks:
        k, v = (torch.randn(b, sk, h, d, generator=g, device=device).to(torch.bfloat16)
                for _ in range(2))
        meta = fa._fwd_meta(q, k, v, out, None)
        picked = fa.fwd_sm90_instantiation(d, s, sk)
        for i, (depth, width, cons, blocks, tiles) in enumerate(BLOCKS):
            if width not in (picked[1], before) or (tiles and sk > RESIDENT_KEYS):
                continue
            info = (ctypes.c_longlong * 14)()
            if lib.breakdown_block_attributes(i, info):
                raise RuntimeError(f"block {i}: no attributes")
            lib.breakdown_block(i)
            ms, dev = {}, {}
            for static_max in (True, False):
                fn = lambda: _call(lib, static_max, q, k, v, out, meta, scale,  # noqa: E731
                                   device, f"block {i}")
                ms[static_max], dev[static_max] = time_ms(fn, device), device_ms(fn, "flash_fwd")
            rows = 64 * tiles if tiles > 0 else 0 if tiles else 64 * cons
            mark = " (picked)" if (depth, width, rows, blocks) == picked else ""
            kind = (f"K/V-resident, {cons} consumer(s), {info[13]} Q stages, "
                    f"{info[4]} bytes of shared memory" if tiles else f"{cons} consumer(s)")
            shown = rows or 64 * fa.resident_split(b, s, h)[0]
            print(f"block {depth}/{width}, {shown} rows{' (at launch)' if tiles < 0 else ''}, "
                  f"{blocks} an SM ({kind}){mark} D={d} "
                  f"Sq={s} Sk={sk}: static max {ms[True]:.4f} ms, online {ms[False]:.4f} ms; "
                  f"device {_dev(dev[True])} / {_dev(dev[False])} ({info[2]} "
                  f"registers a consumer thread, {info[3]} spill bytes, {info[5]} resident an "
                  f"SM, {info[10]} K/V stages)", flush=True)
        lib.breakdown_block(-1)
        del k, v
    del q, out
    torch.cuda.empty_cache()


def time_shape(libs, device, shape, sks):
    """Prints sdpa, K1 (at key lengths up to 1024) and every variant at one
    query shape over each key length."""
    b, s, h, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device=device).to(torch.bfloat16)
    out = torch.empty_like(q)
    scale = d ** -0.5
    for sk in sks:
        k, v = (torch.randn(b, sk, h, d, generator=g, device=device).to(torch.bfloat16)
                for _ in range(2))
        meta = fa._fwd_meta(q, k, v, out, None)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale), device)
        print(f"{device_label(device)}; B={b} Sq={s} Sk={sk} H={h} D={d} bf16; "
              f"scaled_dot_product_attention {sdpa:.3f} ms", flush=True)
        if not fa.streams_kv(sk):  # K1's key lengths: the wrapper and its kernel
            k1 = lambda: fa.flash_small_kv(q, k, v, None, scale)
            dev = device_ms(k1, "flash_fwd_sm90")
            print(f"flash_small_kv (K1) {time_ms(k1, device):.3f} ms by CUDA events around the "
                  f"wrapper, " + (f"{dev:.3f} ms" if dev is not None else "not traced")
                  + " of its kernel's device time a call under torch.profiler", flush=True)
        for name, lib in libs.items():
            ms = {static_max: time_ms(lambda: _call(lib, static_max, q, k, v, out, meta, scale,
                                                    device, f"variant {name!r}"), device)
                  for static_max in (True, False)}
            print(f"{name:14s} D={d} Sq={s} Sk={sk:4d} static max {ms[True]:.3f} ms, online "
                  f"{ms[False]:.3f} ms", flush=True)
        del k, v
    del q, out
    torch.cuda.empty_cache()


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("fwd_sm90_breakdown times CUDA kernel variants: it needs a CUDA device")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=["2b"])
    p.add_argument("--blocks", action="store_true",
                   help="time the blocks of BLOCKS instead of the variants")
    p.add_argument("--chain", action="store_true",
                   help="time the chain's and the turns' variants (_CHAIN) instead of the parts")
    args = p.parse_args(argv)
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    source = kernel_source()
    if args.blocks:
        lib = build({"blocks": blocks_source(source)})["blocks"]
        lib.breakdown_block.argtypes = [ctypes.c_int]
        lib.breakdown_block.restype = None
        lib.breakdown_block_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        for name in args.shapes:
            time_blocks(lib, device, *SHAPES[name])
        return
    edits = _CHAIN if args.chain else _EDITS
    libs = build({name: variant_source(name, source, edits) for name in edits})
    for name in args.shapes:
        time_shape(libs, device, *SHAPES[name])


if __name__ == "__main__":
    main()
