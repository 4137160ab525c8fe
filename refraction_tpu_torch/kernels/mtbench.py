"""Sub-visit instrument kernels (``csrc/mtbench.cu``): port of the two
Pallas bodies of ``tools/mxu_mt_bench.py``, ``_vpu_kernel`` (44) and
``_mxu_kernel`` (96), the second in two forms.

All run V sub visits of 8 triangles against R rays with a carried
winner; visit ``s`` reads sub record ``s % 64`` and names its triangles
``s*8 + k``. Misses end at ``t = 1e30``, ``i = 0``.

- `mt_visits`: Möller–Trumbore on the (64*72,) triangle records
  ``a e1 e2`` (8 per sub), with ``inv_det = 1/det`` and products.
- `woop_visits`: per visit the (48, 8) Woop rows of the sub times the ray
  column ``[ox oy oz 1 dx dy dz 0]``, summed over k = 0..7 in order,
  then ``t = -o'z/d'z`` and the packed-key min ``(bits(t) & ~7) | k``
  over the 8 triangles (near-equal t fall to the lower k). The product
  runs on CUDA cores.
- `woop_visits_tc`, `woop_visits_tc3`: the same function with the product
  on the tensor cores (``mma.sync`` m16n8k8, TF32 operands, float32
  accumulators), which is the question ``_mxu_kernel`` puts to the TPU's
  matrix unit: one pass with both operands rounded to TF32 (`tf32_round`),
  or three (3xTF32: ``x = hi + lo``, ``hi = tf32(x)``,
  ``lo = tf32(x - hi)``, and ``lo*hi + hi*lo + hi*hi``).

Rays are columns: ``o``/``d`` (3, R), ``rhs`` (8, R), ``cull`` (R,) with
+1 accepting front faces and -1 back faces. `make_inputs` rebuilds the
tool's own arrays (R = 1,024). Each wrapper launches its kernel for CUDA
tensors and takes its plain version for CPU tensors; the plain versions
run the kernels' float32 operations in the kernels' order, so `mt_visits`
and `woop_visits` agree with theirs bit for bit. The tensor cores do not
specify the order in which they add a row's eight products, so
`woop_visits_tc*` agree with `woop_visits_tc_plain` (the same rounded
operands, the products summed in float32 in K order) to a tolerance:
`TC_T_RTOL` on t where both name the same triangle, and the same triangle
on all but `TC_MISMATCH_SHARE` of the rays (an accept test or the packed
key's three dropped bits deciding within the sum-order error). Measured
on an NVIDIA H100 at V = 8, 70 and 512 with both cull mixes: the same
triangle on every ray, t within 6.0e-5, and 61-72% (one pass) or 23-46%
(3xTF32) of the rays equal bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from refraction_tpu_torch.kernels._build import check, library

SUBS = 64          # sub records in the tables
TRIS = 8           # triangles per sub visit
SUB_WORDS = 72     # 8 x (a[3] e1[3] e2[3])
WOOP_ROWS = 48     # o'x o'y o'z d'x d'y d'z, 8 rows each
WOOP_K = 8         # ox oy oz 1 dx dy dz 0
TMIN = 1e-3
BIG = 1e30
_SUB, _LANE = 8, 128  # the tool's (8, 128) ray planes
# woop_visits_tc* against woop_visits_tc_plain (see the module doc).
TC_T_RTOL = 2e-4
TC_MISMATCH_SHARE = 0.01


class MtInputs(NamedTuple):
    """The arrays of ``tools/mxu_mt_bench.py::main`` (152-186)."""

    tri_flat: np.ndarray  # (4608,) float32 records a e1 e2
    o: np.ndarray         # (3, 8, 128) ray origins
    d: np.ndarray         # (3, 8, 128) unit ray directions
    cu: np.ndarray        # (8, 128) cull signs (all +1)
    W: np.ndarray         # (3072, 8) Woop rows, 48 per sub
    rhs: np.ndarray       # (8, 1024) rows ox oy oz 1 dx dy dz 0
    cu_wide: np.ndarray   # (8, 1024) cu broadcast over the 8 triangle rows


def make_inputs(seed: int = 0) -> MtInputs:
    """The tool's numpy construction, step for step: 64 x 8 random
    triangles, their Woop transforms T = inv([e1 e2 n]) with
    n = cross(e2, e1) (so d'z = det_MT / |n|^2, MT's culling sign), and
    1,024 rays near the origin."""
    rng = np.random.default_rng(seed)
    tris = rng.normal(size=(SUBS, TRIS, 3, 3)).astype(np.float32)
    a = tris[:, :, 0]
    e1 = tris[:, :, 1] - tris[:, :, 0]
    e2 = tris[:, :, 2] - tris[:, :, 0]
    tri_flat = np.concatenate([a, e1, e2], axis=-1).reshape(SUBS * TRIS * 9)

    n = np.cross(e2, e1)
    m = np.stack([e1, e2, n], axis=-1)
    minv = np.linalg.inv(m)
    b = -np.einsum("csij,csj->csi", minv, a)
    w = np.zeros((SUBS, WOOP_ROWS, WOOP_K), np.float32)
    for c in range(SUBS):
        for s in range(TRIS):
            for ax in range(3):
                w[c, ax * 8 + s, 0:3] = minv[c, s, ax]
                w[c, ax * 8 + s, 3] = b[c, s, ax]
                w[c, 24 + ax * 8 + s, 4:7] = minv[c, s, ax]
    w = w.reshape(SUBS * WOOP_ROWS, WOOP_K)

    o = rng.normal(size=(3, _SUB, _LANE)).astype(np.float32) * 0.1
    d = rng.normal(size=(3, _SUB, _LANE)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cu = np.ones((_SUB, _LANE), np.float32)

    rhs = np.zeros((WOOP_K, _SUB * _LANE), np.float32)
    for k in range(3):
        rhs[k] = o[k].reshape(-1)
        rhs[4 + k] = d[k].reshape(-1)
    rhs[3] = 1.0
    cu_wide = np.broadcast_to(cu.reshape(1, -1), (_SUB, _SUB * _LANE)).copy()
    return MtInputs(tri_flat, o, d, cu, w, rhs, cu_wide)


def _cull(inp: MtInputs, device, cull) -> torch.Tensor:
    c = inp.cu.reshape(-1) if cull is None else np.asarray(cull, np.float32)
    return torch.tensor(c, dtype=torch.float32, device=device)


def mt_args(inp: MtInputs, device, cull=None):
    """``(tri_flat, o, d, cull)`` for `mt_visits` on ``device``; ``cull``
    (R,) defaults to the tool's all-ones ``cu``."""
    put = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return (put(inp.tri_flat), put(inp.o.reshape(3, -1)),
            put(inp.d.reshape(3, -1)), _cull(inp, device, cull))


def woop_args(inp: MtInputs, device, cull=None):
    """``(W, rhs, cull)`` for `woop_visits` on ``device``."""
    put = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return put(inp.W), put(inp.rhs), _cull(inp, device, cull)


def _check(named, device, v: int) -> None:
    for name, x, shape in named:
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != device or not x.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous float32 {shape} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if v < 0:
        raise ValueError(f"V: want >= 0 visits, got {v}")


def _check_mt(tri_flat, o, d, cull, v):
    r = o.shape[1] if o.dim() == 2 else -1
    _check((("tri_flat", tri_flat, (SUBS * SUB_WORDS,)), ("o", o, (3, r)),
            ("d", d, (3, r)), ("cull", cull, (r,))), o.device, v)


def _check_woop(w, rhs, cull, v):
    r = rhs.shape[1] if rhs.dim() == 2 else -1
    _check((("W", w, (SUBS * WOOP_ROWS, WOOP_K)), ("rhs", rhs, (WOOP_K, r)),
            ("cull", cull, (r,))), rhs.device, v)


def _empty_out(r: int, device):
    return (torch.empty(r, dtype=torch.float32, device=device),
            torch.empty(r, dtype=torch.int32, device=device))


def mt_visits_plain(tri_flat, o, d, cull, v: int):
    """`mt_visits` in plain PyTorch: vectorized over rays, a Python loop
    over visits and the 8 triangles, the kernel's float32 operations in
    its order (IEEE reciprocal as a tensor divide)."""
    _check_mt(tri_flat, o, d, cull, v)
    words = tri_flat.cpu().tolist()  # the uniform per-triangle scalars
    ox, oy, oz = o
    dx, dy, dz = d
    one = torch.ones_like(ox)
    bt = torch.full_like(ox, BIG)
    bi = torch.zeros(ox.shape, dtype=torch.int32, device=o.device)
    for s in range(v):
        for k in range(TRIS):
            tb = (s % SUBS) * SUB_WORDS + k * 9
            a0, a1, a2, e10, e11, e12, e20, e21, e22 = words[tb:tb + 9]
            px = dy * e22 - dz * e21
            py = dz * e20 - dx * e22
            pz = dx * e21 - dy * e20
            det = e10 * px + e11 * py + e12 * pz
            accept = det * cull > 0.0
            tvx, tvy, tvz = ox - a0, oy - a1, oz - a2
            u_num = tvx * px + tvy * py + tvz * pz
            qx = tvy * e12 - tvz * e11
            qy = tvz * e10 - tvx * e12
            qz = tvx * e11 - tvy * e10
            v_num = dx * qx + dy * qy + dz * qz
            t_num = e20 * qx + e21 * qy + e22 * qz
            inv_det = one / det
            u = u_num * inv_det
            vv = v_num * inv_det
            t = t_num * inv_det
            upd = (accept & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0)
                   & (t >= TMIN) & (t < bt))
            bt = torch.where(upd, t, bt)
            bi = torch.where(upd, s * TRIS + k, bi)
    return bt, bi


def _ordered_product(ws, rhs, out=None):
    """``out + ws @ rhs`` for ws (48, 8), rhs (8, R) as a sum over k =
    0..7 in order, float32 products and adds (not a matmul)."""
    for k in range(WOOP_K):
        term = ws[:, k:k + 1] * rhs[k:k + 1]
        out = term if out is None else out + term
    return out


def _woop_visits(product, rhs, cull, v: int):
    """The Woop visits around ``product(s) -> (48, R)``, the outputs of
    visit s: the epilogue and the packed-key min over the 8 triangle
    rows, then the strict ``t < best`` across visits."""
    r = rhs.shape[1]
    k_idx = torch.arange(TRIS, dtype=torch.int32, device=rhs.device)[:, None]
    one = torch.ones(TRIS, r, dtype=torch.float32, device=rhs.device)
    bt = torch.full((r,), BIG, dtype=torch.float32, device=rhs.device)
    bi = torch.zeros(r, dtype=torch.int32, device=rhs.device)
    for s in range(v):
        oxp, oyp, ozp, dxp, dyp, dzp = product(s).reshape(6, TRIS, r)
        inv = one / dzp
        t = -ozp * inv
        u = oxp + t * dxp
        vv = oyp + t * dyp
        cond = ((dzp * cull > 0.0) & (u >= 0.0) & (vv >= 0.0)
                & (u + vv <= 1.0) & (t >= TMIN))
        tt = torch.where(cond, t, BIG)
        key = (tt.view(torch.int32) & ~7) | k_idx
        win = key.amin(dim=0) & 7
        rt = tt.gather(0, win[None].long())[0]
        upd = rt < bt
        bt = torch.where(upd, rt, bt)
        bi = torch.where(upd, s * TRIS + win, bi)
    return bt, bi


def woop_visits_plain(w, rhs, cull, v: int):
    """`woop_visits` in plain PyTorch: per visit the (48, R) product as the
    same ordered sum over k (not a matmul), then the epilogue and the
    packed-key min over the 8 triangle rows."""
    _check_woop(w, rhs, cull, v)
    subs = w.reshape(SUBS, WOOP_ROWS, WOOP_K)
    return _woop_visits(lambda s: _ordered_product(subs[s % SUBS], rhs),
                        rhs, cull, v)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits): to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds, done on the bits: add
    half a TF32 ulp (0x1000) to the magnitude and clear the low 13 bits.
    Subnormals round on the same grid; the largest finite values round to
    infinity; for finite inputs."""
    return ((x.contiguous().view(torch.int32) + 0x1000)
            & ~0x1FFF).view(torch.float32)


def woop_visits_tc_plain(w, rhs, cull, v: int, passes: int = 1):
    """`woop_visits_tc` (``passes`` 1) and `woop_visits_tc3` (3) in plain
    PyTorch: the operands rounded (and split) as the kernel does, every
    product exact in float32, summed in float32 over k = 0..7 and, for
    three passes, over ``lo*hi``, ``hi*lo``, ``hi*hi`` in that order; then
    `woop_visits_plain`'s epilogue."""
    _check_woop(w, rhs, cull, v)
    if passes not in (1, 3):
        raise ValueError(f"passes: want 1 (TF32) or 3 (3xTF32), got {passes}")
    w_hi, k_hi = tf32_round(w), tf32_round(rhs)
    w_lo, k_lo = tf32_round(w - w_hi), tf32_round(rhs - k_hi)
    hi, lo = (x.reshape(SUBS, WOOP_ROWS, WOOP_K) for x in (w_hi, w_lo))

    def product(s):
        out = None
        if passes == 3:
            out = _ordered_product(lo[s % SUBS], k_hi)
            out = _ordered_product(hi[s % SUBS], k_lo, out)
        return _ordered_product(hi[s % SUBS], k_hi, out)

    return _woop_visits(product, rhs, cull, v)


def mt_visits(tri_flat, o, d, cull, v: int):
    """(t (R,) float32, i (R,) int32) after ``v`` Möller–Trumbore sub
    visits; see the module doc. On CUDA: one launch, no host sync."""
    _check_mt(tri_flat, o, d, cull, v)
    if o.device.type == "cpu":
        return mt_visits_plain(tri_flat, o, d, cull, v)
    if o.device.type != "cuda":
        raise ValueError(f"mt_visits: unsupported device {o.device}")
    r = o.shape[1]
    t, i = _empty_out(r, o.device)
    if r == 0:
        return t, i
    err = library().rt_mt_visits(
        tri_flat.data_ptr(), o.data_ptr(), d.data_ptr(), cull.data_ptr(), r,
        v, t.data_ptr(), i.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    check(err, "rt_mt_visits")
    mt_visits.launches += 1
    return t, i


def woop_visits(w, rhs, cull, v: int):
    """(t (R,) float32, i (R,) int32) after ``v`` Woop sub visits; see the
    module doc. On CUDA: one launch, no host sync."""
    _check_woop(w, rhs, cull, v)
    if rhs.device.type == "cpu":
        return woop_visits_plain(w, rhs, cull, v)
    if rhs.device.type != "cuda":
        raise ValueError(f"woop_visits: unsupported device {rhs.device}")
    if w.data_ptr() % 16:
        raise ValueError("W: the kernel reads it as float4, want a 16-byte "
                         "aligned start")
    r = rhs.shape[1]
    t, i = _empty_out(r, rhs.device)
    if r == 0:
        return t, i
    err = library().rt_woop_visits(
        w.data_ptr(), rhs.data_ptr(), cull.data_ptr(), r, v, t.data_ptr(),
        i.data_ptr(), torch.cuda.current_stream(rhs.device).cuda_stream)
    check(err, "rt_woop_visits")
    woop_visits.launches += 1
    return t, i


def _woop_visits_tc(wrapper, passes: int, w, rhs, cull, v: int):
    _check_woop(w, rhs, cull, v)
    if rhs.device.type == "cpu":
        return woop_visits_tc_plain(w, rhs, cull, v, passes)
    if rhs.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{rhs.device}")
    r = rhs.shape[1]
    t, i = _empty_out(r, rhs.device)
    if r == 0:
        return t, i
    err = library().rt_woop_visits_tc(
        w.data_ptr(), rhs.data_ptr(), cull.data_ptr(), r, v, passes,
        t.data_ptr(), i.data_ptr(),
        torch.cuda.current_stream(rhs.device).cuda_stream)
    check(err, "rt_woop_visits_tc")
    wrapper.launches += 1
    return t, i


def woop_visits_tc(w, rhs, cull, v: int):
    """`woop_visits` with the product on the tensor cores in one TF32 pass
    (both operands rounded to 10 mantissa bits); see the module doc. On
    CUDA: one launch, no host sync."""
    return _woop_visits_tc(woop_visits_tc, 1, w, rhs, cull, v)


def woop_visits_tc3(w, rhs, cull, v: int):
    """`woop_visits` with the product on the tensor cores as 3xTF32 (three
    passes over split operands, close to float32); see the module doc. On
    CUDA: one launch, no host sync."""
    return _woop_visits_tc(woop_visits_tc3, 3, w, rhs, cull, v)


def tc_agreement(got, ref) -> dict:
    """How a tensor-core result (t, i) agrees with its plain version's:
    ``exact`` (share of rays with equal t bits and equal i), ``same_i``
    (share with the same triangle or both a miss), ``t_rel`` (largest
    relative t difference over rays with the same triangle hit), and
    ``ok`` by `TC_T_RTOL` and `TC_MISMATCH_SHARE`."""
    (tk, ik), (tp, ip) = got, ref
    hit_k, hit_p = tk < 1e29, tp < 1e29
    same = (hit_k == hit_p) & ((ik == ip) | ~hit_p)
    both = same & hit_p
    t_rel = (float(((tk - tp).abs() / tp.abs())[both].max())
             if bool(both.any()) else 0.0)
    exact = float(((tk == tp) & (ik == ip)).float().mean())
    same_i = float(same.float().mean())
    return {"exact": exact, "same_i": same_i, "t_rel": t_rel,
            "ok": t_rel <= TC_T_RTOL and 1.0 - same_i <= TC_MISMATCH_SHARE}


mt_visits.launches = 0
woop_visits.launches = 0
woop_visits_tc.launches = 0
woop_visits_tc3.launches = 0
