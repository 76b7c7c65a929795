"""Exact segment sums as matrix products (factored one-hot histograms).

For a provably-small group count S, segment-sum becomes a matrix product:
factor the slot id into (hi, lo) digits, build two one-hot operands, and
contract  result[hi, lo] = sum_rows (onehot_hi * value)^T @ onehot_lo  —
the matrix unit does the "scatter".  Whether this beats an atomic
scatter-add (`jax.ops.segment_sum`) on a given device is a measurement,
not an assumption; both give the same integers.

Exactness invariant: every product multiplies only 0/1 one-hot entries and
8-bit limbs (0..255), and accumulates in float32 per chunk of at most
65536 rows, so every partial sum is an integer below 2^24.  Such operands
are exact in any reduced-precision matrix mode a device may pick for f32
inputs (TF32 keeps 11 significant bits, bf16 keeps 8, and an integer in
0..255 needs at most 8), and the f32 accumulator is exact below 2^24.
So these products need no `precision` argument:
  * counts: per-chunk counts <= chunk size (65536) — exact;
  * integer sums: values biased to unsigned and split into 8-bit limbs
    (limb sums per chunk <= 65536*255 < 2^24 — exact); limbs recombined in
    modular u64 arithmetic, bias removed with the exact counts.
Cross-chunk carries are integer (i32/u64).  Float sums are served by the
sort path (scan_ops) instead.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = ["MAX_DENSE_GROUPS", "mxu_counts_and_sums"]

MAX_DENSE_GROUPS = 16384          # 128 x 128 factorization
# chunk bound: worst-case per-chunk limb sums must stay f32-exact:
# CHUNK * 255 < 2^24  =>  CHUNK <= 65793
_CHUNK = 1 << 16


def _factor(S: int) -> Tuple[int, int]:
    # Balanced factorization: S=1024 becomes (32, 32) rather than (8, 128),
    # keeping both one-hot operands equally wide.
    s2 = 1 << ((max(S - 1, 1).bit_length() + 1) // 2)
    s2 = max(8, min(s2, 128))
    s1 = (S + s2 - 1) // s2
    return s1, s2


def _limbs_for(v: jax.Array, signed: bool,
               bounds: Optional[Tuple[int, int]]) -> Tuple[int, bool]:
    """(limb count, needs_bias).  Proven-nonnegative values skip the sign
    bias and only carry as many 8-bit limbs as their range needs."""
    if bounds is not None and bounds[0] >= 0:
        bits = max(int(bounds[1]).bit_length(), 1)
        return (bits + 7) // 8, False
    return 8, signed


def mxu_group_reduce(ids, base_mask, count_masks, sum_specs, S):
    """Batched dense reductions in ONE pass over the data.

    count_masks -- one count output per entry (None entry = base_mask)
    sum_specs   -- (values, signed, bounds, mask or None) per sum output
    Returns ([counts...], [sums...]).  All aggregates of a GROUP BY share the
    one-hot construction and the scan — one data read total.  Sign-biased
    sums get an internal matching count to remove the bias exactly.
    """
    assert S <= MAX_DENSE_GROUPS
    s1, s2 = _factor(S)
    n = ids.shape[0]
    n_pad = ((n + _CHUNK - 1) // _CHUNK) * _CHUNK
    pad = n_pad - n

    def padded(a, fill=0):
        if pad == 0:
            return a
        return jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])

    R = n_pad // _CHUNK
    ids_c = padded(ids.astype(jnp.int32)).reshape(R, _CHUNK)
    base_c = padded(base_mask, False).reshape(R, _CHUNK)

    sspecs = []          # (n_limbs, biased, signed, has_mask)
    svals_c = []
    smask_c = []
    bias_count_idx = []  # per sum: index into the count list (or None)
    all_count_masks = list(count_masks)
    for v, signed, b, m in sum_specs:
        n_limbs, biased = _limbs_for(v, signed, b)
        sspecs.append((n_limbs, biased, signed, m is not None))
        u = v.astype(jnp.uint64)
        if biased:
            u = u + jnp.uint64(1 << 63)
            bias_count_idx.append(len(all_count_masks))
            all_count_masks.append(m)      # count with this sum's mask
        else:
            bias_count_idx.append(None)
        svals_c.append(padded(u).reshape(R, _CHUNK))
        if m is not None:
            smask_c.append(padded(m, False).reshape(R, _CHUNK))

    cmask_c = [padded(m, False).reshape(R, _CHUNK) if m is not None else None
               for m in all_count_masks]
    has_cmask = [m is not None for m in cmask_c]
    cmask_present = [m for m in cmask_c if m is not None]

    r1 = jnp.arange(s1, dtype=jnp.int32)
    r2 = jnp.arange(s2, dtype=jnp.int32)
    kc = len(all_count_masks)
    ks = len(svals_c)

    def body(carry, xs):
        caccs, laccs = carry
        pos = 0
        iv = xs[pos]; pos += 1
        bm = xs[pos]; pos += 1
        cms_present = xs[pos:pos + len(cmask_present)]
        pos += len(cmask_present)
        svs = xs[pos:pos + ks]
        pos += ks
        sms_present = xs[pos:]

        hi = iv // s2
        lo = iv - hi * s2
        ohh = ((hi[:, None] == r1[None, :]) & bm[:, None]).astype(jnp.float32)
        ohl = (lo[:, None] == r2[None, :]).astype(jnp.float32)

        new_caccs = []
        ci = 0
        for acc, has in zip(caccs, has_cmask):
            if has:
                lhs = ohh * cms_present[ci][:, None].astype(jnp.float32)
                ci += 1
            else:
                lhs = ohh
            new_caccs.append(acc + jnp.dot(
                lhs.T, ohl, preferred_element_type=jnp.float32
            ).astype(jnp.int32))

        new_laccs = []
        mi = 0
        for (n_limbs, biased, _, has_mask), acc, vv in zip(sspecs, laccs, svs):
            if has_mask:
                base = ohh * sms_present[mi][:, None].astype(jnp.float32)
                mi += 1
            else:
                base = ohh
            sums = []
            for l in range(n_limbs):
                limb = ((vv >> jnp.uint64(8 * l)) & jnp.uint64(0xFF)
                        ).astype(jnp.float32)
                sums.append(jnp.dot((base * limb[:, None]).T, ohl,
                                    preferred_element_type=jnp.float32
                                    ).astype(jnp.uint32))
            new_laccs.append(acc + jnp.stack(sums).astype(jnp.uint64))
        return (new_caccs, new_laccs), None

    init = ([jnp.zeros((s1, s2), jnp.int32) for _ in range(kc)],
            [jnp.zeros((sspecs[i][0], s1, s2), jnp.uint64)
             for i in range(ks)])
    xs = tuple([ids_c, base_c] + cmask_present + svals_c + smask_c)
    (caccs, laccs), _ = jax.lax.scan(body, init, xs)

    all_counts = [c.reshape(s1 * s2)[:S].astype(jnp.int64) for c in caccs]
    counts = all_counts[:len(count_masks)]
    sums = []
    for (n_limbs, biased, signed, _), limbs, bidx in zip(sspecs, laccs,
                                                         bias_count_idx):
        flat = limbs.reshape(n_limbs, s1 * s2)[:, :S]
        total = jnp.zeros((S,), jnp.uint64)
        for l in range(n_limbs):
            total = total + (flat[l] << jnp.uint64(8 * l))
        if biased:
            cnt = all_counts[bidx]
            total = total - cnt.astype(jnp.uint64) * jnp.uint64(1 << 63)
        sums.append(total.astype(jnp.int64) if signed else total)
    return counts, sums


def mxu_counts_and_sums(ids: jax.Array, mask: jax.Array,
                        int_values: Sequence[Tuple[jax.Array, bool]],
                        S: int,
                        bounds: Sequence[Optional[Tuple[int, int]]] = ()
                        ) -> Tuple[jax.Array, List[jax.Array]]:
    """-> (counts (S,) int64, [sums (S,) i64/u64 matching each value]).

    ids        -- int32 slot per row, in [0, S) (rows with mask=False ignored)
    int_values -- list of (values, is_signed); values any integer dtype
    bounds     -- optional proven (lo, hi) per value (fewer limbs, no bias)

    Per-chunk partial sums are exact in the f32 accumulator (< 2^24; see
    the module docstring); cross-chunk carries are integer (i32/u64).
    """
    assert S <= MAX_DENSE_GROUPS
    s1, s2 = _factor(S)
    n = ids.shape[0]
    n_pad = ((n + _CHUNK - 1) // _CHUNK) * _CHUNK
    pad = n_pad - n

    def padded(a, fill=0):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,), fill, a.dtype)])

    specs = []          # (n_limbs, biased)
    vals_u64 = []
    for i, (v, signed) in enumerate(int_values):
        b = bounds[i] if i < len(bounds) else None
        n_limbs, biased = _limbs_for(v, signed, b)
        specs.append((n_limbs, biased))
        u = v.astype(jnp.uint64)
        if biased:
            u = u + jnp.uint64(1 << 63)        # bias to unsigned
        vals_u64.append(padded(u))

    ids_p = padded(ids.astype(jnp.int32))
    mask_p = padded(mask, False)
    R = n_pad // _CHUNK
    ids_c = ids_p.reshape(R, _CHUNK)
    mask_c = mask_p.reshape(R, _CHUNK)
    vals_c = [v.reshape(R, _CHUNK) for v in vals_u64]

    k = len(vals_u64)
    hi_range = jnp.arange(s1, dtype=jnp.int32)
    lo_range = jnp.arange(s2, dtype=jnp.int32)

    def body(carry, xs):
        count_acc, limb_accs = carry
        iv = xs[0]
        mv = xs[1]
        vs = xs[2:]
        hi = iv // s2
        lo = iv - hi * s2
        ohh = ((hi[:, None] == hi_range[None, :]) & mv[:, None]
               ).astype(jnp.float32)                        # (C, s1)
        ohl = (lo[:, None] == lo_range[None, :]).astype(jnp.float32)  # (C, s2)
        count_acc = count_acc + jnp.dot(
            ohh.T, ohl, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
        new_limb_accs = []
        for vi, acc, (n_limbs, _) in zip(vs, limb_accs, specs):
            limb_sums = []
            for l in range(n_limbs):
                limb = ((vi >> jnp.uint64(8 * l)) & jnp.uint64(0xFF)
                        ).astype(jnp.float32)
                lhs = ohh * limb[:, None]                   # (C, s1)
                limb_sums.append(jnp.dot(
                    lhs.T, ohl, preferred_element_type=jnp.float32
                ).astype(jnp.uint32))
            new_limb_accs.append(acc + jnp.stack(limb_sums).astype(jnp.uint64))
        return (count_acc, new_limb_accs), None

    init = (jnp.zeros((s1, s2), jnp.int32),
            [jnp.zeros((specs[i][0], s1, s2), jnp.uint64) for i in range(k)])
    (count_acc, limb_accs), _ = jax.lax.scan(
        body, init, tuple([ids_c, mask_c] + vals_c))

    counts = count_acc.reshape(s1 * s2)[:S].astype(jnp.int64)

    sums: List[jax.Array] = []
    for (v, signed), (n_limbs, biased), limbs in zip(int_values, specs,
                                                     limb_accs):
        flat = limbs.reshape(n_limbs, s1 * s2)[:, :S]
        total = jnp.zeros((S,), jnp.uint64)
        for l in range(n_limbs):
            total = total + (flat[l] << jnp.uint64(8 * l))
        if biased:
            total = total - counts.astype(jnp.uint64) * jnp.uint64(1 << 63)
        if signed:
            sums.append(total.astype(jnp.int64))
        else:
            sums.append(total)
    return counts, sums
