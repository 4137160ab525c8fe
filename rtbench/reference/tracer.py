"""The plain reference renderer: what a pixel of the reference demo shows.

Plain PyTorch, written from the upstream demo's shaders
(bottledspace/refraction-raytracing-dxr, RayTracing.hlsl and
RefractionDemo.cpp) after the pattern of the repository's NumPy oracle
(oracle/numpy_tracer.py). It imports nothing of the program and takes
nothing the program made: its camera, rays, triangle edges, normals,
jitter and texel indices are all worked out here from the configuration's
fields, the mesh's corners and normals, the map and the angle.

Per pixel sample (RayTracing.hlsl RayGen:42, ClosestHit:79, Miss:127):

- a pinhole ray from the camera on the orbit, through the pixel at the
  sample's offset, unprojected by ``inv(proj @ world @ view)`` with no
  divide by w (RefractionDemo.cpp:559-566, hlsl:27-40);
- the closest hit over every triangle (Moller-Trumbore, front faces only
  while outside the glass, back faces only inside, tmin <= t <= tmax, ties
  to the lowest triangle index);
- a miss adds weight * the map's texel at (atan2(x, z), acos(y)) with the
  shader's pi 3.14159, truncated and clamped to the map;
- a hit at the refraction cap adds black; any other hit spawns the
  refraction child (weight * (1 - R), side flipped, none on total internal
  reflection) and, while under the reflection cap, the reflection child
  (weight * R, same side), with R the shader's ``R0 (1 - R0) (1 - cos)^5``.

The samples' radiance is summed per pixel in float64 and divided by spp.
``dtype`` is the precision of everything before that sum: float32 for the
reference, bfloat16 for the control that `rtbench.check` must reject.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Elements of one (rays, triangles) temporary of the brute force, on the
# host and on a card (some twenty such temporaries are alive at once).
CHUNK_ELEMS = 2 ** 21
CHUNK_ELEMS_CUDA = 2 ** 25


def _f32(x: float) -> float:
    return float(np.float32(x))


def sample_offsets(spp: int) -> np.ndarray:
    """(spp, 2) sub-pixel offsets: the pixel centre at spp 1; a k x k grid
    of cell centres at square spp; otherwise the first spp cells of the
    next square grid, moved so that their mean is the pixel centre."""
    if spp == 1:
        return np.array([[0.5, 0.5]], np.float32)
    k = math.ceil(math.sqrt(spp))
    cells = [((i + 0.5) / k, (j + 0.5) / k)
             for j in range(k) for i in range(k)]
    off = np.asarray(cells[:spp], np.float32)
    if k * k != spp:
        off = off + (np.float32(0.5) - off.mean(axis=0, dtype=np.float32))
    return off


def aspect(render: dict) -> float:
    """The configuration's aspect, or width / height where it gives none."""
    if render.get("aspect") is not None:
        return float(render["aspect"])
    return render["width"] / render["height"]


def camera(angle: float, render: dict):
    """(origin (3,), unprojection (4, 4)) float32 of the orbit camera at
    ``angle``: DirectXMath's PerspectiveFovLH, TranslationFromVector and
    LookAtLH, composed as proj @ world @ view (row-major), inverted in
    float64. The look-at eye sits on a unit circle at -angle, the ray
    origin on the orbit at +angle, as the demo has them."""
    fov = render["fov_y_deg"] / 180.0 * render["pi_camera"]
    zn, zf = render["z_near"], render["z_far"]
    h = math.cos(fov / 2) / math.sin(fov / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = h / aspect(render)
    proj[1, 1] = h
    proj[2, 2] = zf / (zf - zn)
    proj[2, 3] = 1.0
    proj[3, 2] = -zf / (zf - zn) * zn
    r = render["orbit_radius"]
    loc = np.array([r * math.cos(angle), 0.0, r * math.sin(angle)])
    world = np.eye(4)
    world[3, :3] = loc
    eye = np.array([math.cos(-angle), 0.0, math.sin(-angle)])
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.zeros((4, 4))
    view[:3, 0], view[:3, 1], view[:3, 2] = x, y, z
    view[3, :3] = [-x @ eye, -y @ eye, -z @ eye]
    view[3, 3] = 1.0
    inv = np.linalg.inv(proj @ world @ view)
    return loc.astype(np.float32), inv.astype(np.float32)


class Scene:
    """The mesh and map on ``device`` in ``dtype``: each triangle's first
    corner and two edges, its corner normals as nA, nB - nA, nC - nA, and
    the map.

    ``instances``, for a scene of placed instances (`rtbench.inputs.
    bake_instances`), is ((I, 2) ranges of global triangle indices, (I, 2,
    3) world boxes of their corners): `closest_hit` then tests a ray only
    against the instances whose box, padded by `box_pad`, its segment
    meets."""

    def __init__(self, positions: np.ndarray, normals: np.ndarray,
                 env: torch.Tensor, device, dtype=torch.float32,
                 instances=None):
        pos = torch.as_tensor(np.asarray(positions, np.float32), device=device)
        nrm = torch.as_tensor(np.asarray(normals, np.float32), device=device)
        self.dtype = dtype
        self.a = pos[:, 0].to(dtype)
        self.e1 = (pos[:, 1] - pos[:, 0]).to(dtype)
        self.e2 = (pos[:, 2] - pos[:, 0]).to(dtype)
        self.n0 = nrm[:, 0].to(dtype)
        self.dn1 = (nrm[:, 1] - nrm[:, 0]).to(dtype)
        self.dn2 = (nrm[:, 2] - nrm[:, 0]).to(dtype)
        self.env = env.to(device=device, dtype=dtype)
        self.num_tris = int(pos.shape[0])
        self.chunk_elems = CHUNK_ELEMS_CUDA if pos.is_cuda else CHUNK_ELEMS
        self.parts = None
        if instances is not None:
            ranges, boxes = instances
            boxes = torch.as_tensor(np.asarray(boxes), device=device).double()
            pad = box_pad(boxes, dtype)
            self.box_lo = boxes[:, 0] - pad
            self.box_hi = boxes[:, 1] + pad
            self.starts = [int(lo) for lo, _ in ranges]
            self.parts = [_Part(self, int(lo), int(hi)) for lo, hi in ranges]


class _Part:
    """One instance's triangles of a `Scene`, as views, for `closest_hit`."""

    def __init__(self, sc: Scene, lo: int, hi: int):
        self.a, self.e1, self.e2 = sc.a[lo:hi], sc.e1[lo:hi], sc.e2[lo:hi]
        self.num_tris = hi - lo
        self.chunk_elems = sc.chunk_elems
        self.parts = None


def box_pad(boxes: torch.Tensor, dtype) -> torch.Tensor:
    """(I, 1) float64 pad of each (lo, hi) box in ``boxes`` (I, 2, 3):
    sqrt(eps) of ``dtype`` times the box's largest coordinate plus its
    largest extent. That is thousands of float32 roundings (3.5e-4 of the
    scale) and eleven of bfloat16's: it covers the rounding of the corners
    in ``dtype``, of a hit point that starts a child ray, and of
    Moller-Trumbore's t, so that no triangle a ray can hit in ``dtype``
    lies in a box its segment misses. Only a ray within about 1e-4 rad of
    a triangle's plane could need more in float32."""
    scale = boxes.abs().amax(dim=(1, 2)) + (boxes[:, 1] - boxes[:, 0]).amax(1)
    return (math.sqrt(torch.finfo(dtype).eps) * scale)[:, None]


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def closest_hit(sc: Scene, o, d, outside, tmin: float, tmax: float):
    """(hit (N,), t, u, v, triangle (N,)) of N rays against every triangle
    (for a scene of instances, `closest_hit_culled`)."""
    if sc.parts is not None:
        return closest_hit_culled(sc, o, d, outside, tmin, tmax)
    n = o.shape[0]
    chunk = max(1, sc.chunk_elems // max(sc.num_tris, 1))
    big = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    a, e1, e2 = sc.a[None], sc.e1[None], sc.e2[None]
    parts = []
    for s in range(0, n, chunk):
        dd = d[s:s + chunk, None, :]
        tv = o[s:s + chunk, None, :] - a
        px = dd[..., 1] * e2[..., 2] - dd[..., 2] * e2[..., 1]
        py = dd[..., 2] * e2[..., 0] - dd[..., 0] * e2[..., 2]
        pz = dd[..., 0] * e2[..., 1] - dd[..., 1] * e2[..., 0]
        det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
        face = torch.where(outside[s:s + chunk, None], det > 0, det < 0)
        inv = 1.0 / torch.where(face, det, torch.ones_like(det))
        u = (tv[..., 0] * px + tv[..., 1] * py + tv[..., 2] * pz) * inv
        qx = tv[..., 1] * e1[..., 2] - tv[..., 2] * e1[..., 1]
        qy = tv[..., 2] * e1[..., 0] - tv[..., 0] * e1[..., 2]
        qz = tv[..., 0] * e1[..., 1] - tv[..., 1] * e1[..., 0]
        v = (dd[..., 0] * qx + dd[..., 1] * qy + dd[..., 2] * qz) * inv
        t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv
        ok = (face & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tmin)
              & (t <= tmax))
        t_best, idx = torch.min(torch.where(ok, t, big), dim=1)
        rows = torch.arange(idx.shape[0], device=o.device)
        parts.append((t_best < big, t_best, u[rows, idx], v[rows, idx], idx))
    return tuple(torch.cat([p[k] for p in parts]) for k in range(5))


def segment_meets(o, d, tmin: float, tmax: float, lo, hi):
    """(N, I) bool: the segment o + t d, tmin <= t <= tmax, of each of N
    rays meets each of I boxes [lo, hi] (I, 3): a slab test in float64,
    where a ray parallel to a slab meets it only from inside."""
    o64, d64 = o.double()[:, None, :], d.double()[:, None, :]
    flat = d64 == 0
    step = torch.where(flat, torch.ones_like(d64), d64)
    t1, t2 = (lo[None] - o64) / step, (hi[None] - o64) / step
    inside = (o64 >= lo[None]) & (o64 <= hi[None])
    inf = torch.full_like(t1, math.inf)
    near = torch.where(flat, torch.where(inside, -inf, inf),
                       torch.minimum(t1, t2))
    far = torch.where(flat, torch.where(inside, inf, -inf),
                      torch.maximum(t1, t2))
    t_in = torch.clamp(near.amax(dim=2), min=tmin)
    t_out = torch.clamp(far.amin(dim=2), max=tmax)
    return t_in <= t_out


def closest_hit_culled(sc: Scene, o, d, outside, tmin: float, tmax: float):
    """`closest_hit` of a scene of instances: each instance's triangles,
    by `closest_hit`'s brute force, against the rays whose [tmin, tmax]
    segment meets the instance's padded box, in the order of the global
    indices. A later instance wins only at a smaller t, so a tie goes to
    the lowest global index, and hit, t, u, v and the triangle of a ray
    that hits equal the brute force's over every triangle (a miss has t
    inf and triangle 0, as there, and u = v = 0, which nothing reads)."""
    n = o.shape[0]
    dev = o.device
    t_best = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
    u_best = torch.zeros(n, dtype=o.dtype, device=dev)
    v_best = torch.zeros(n, dtype=o.dtype, device=dev)
    idx_best = torch.zeros(n, dtype=torch.int64, device=dev)
    # The slab test's (rows, I, 3) float64 temporaries hold about as many
    # bytes as one temporary of the brute force.
    rows = max(1, sc.chunk_elems // (6 * len(sc.parts)))
    for s in range(0, n, rows):
        meets = segment_meets(o[s:s + rows], d[s:s + rows], tmin, tmax,
                              sc.box_lo, sc.box_hi)
        for i, (lo, part) in enumerate(zip(sc.starts, sc.parts)):
            ray = torch.nonzero(meets[:, i]).squeeze(1) + s
            if ray.numel() == 0:
                continue
            hit, t, u, v, idx = closest_hit(part, o[ray], d[ray],
                                            outside[ray], tmin, tmax)
            win = hit & (t < t_best[ray])
            ray = ray[win]
            t_best[ray] = t[win]
            u_best[ray] = u[win]
            v_best[ray] = v[win]
            idx_best[ray] = idx[win] + lo
    return torch.isfinite(t_best), t_best, u_best, v_best, idx_best


def env_texel(sc: Scene, d):
    """The map's texel each unit direction ``d`` looks up (hlsl:133-134)."""
    h, w = sc.env.shape[0], sc.env.shape[1]
    pi = torch.tensor(3.14159, dtype=d.dtype, device=d.device)
    theta = float(w) * (torch.atan2(d[:, 0], d[:, 2]) / pi + 1.0) / 2.0
    phi = float(h) * (torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / pi)
    ix = torch.clamp(theta.to(torch.int64), 0, w - 1)
    iy = torch.clamp(phi.to(torch.int64), 0, h - 1)
    return sc.env[iy, ix]


def primary_rays(sc: Scene, render: dict, angles, pixels,
                 offset: np.ndarray):
    """(origins, dirs) (V * K, 3) of the flat pixel ids ``pixels`` (V, K)
    seen from the V orbit ``angles``, for one sample ``offset`` (2,), in
    the scene's dtype."""
    dt, dev = sc.dtype, pixels.device
    cams = [camera(a, render) for a in angles]
    origin = torch.as_tensor(np.stack([c[0] for c in cams]), device=dev)
    coef = torch.as_tensor(np.stack([c[1][:3][:, [0, 1, 3]] for c in cams]),
                           device=dev).to(dt)
    wt = torch.tensor(float(render["width"]), dtype=dt, device=dev)
    ht = torch.tensor(float(render["height"]), dtype=dt, device=dev)
    px = (pixels % render["width"]).to(dt)
    py = (pixels // render["width"]).to(dt)
    sx = (px + float(offset[0])) / wt * 2.0 - 1.0
    sy = -((py + float(offset[1])) / ht * 2.0 - 1.0)
    r = [coef[:, i, 0, None] * sx + coef[:, i, 1, None] * sy
         + coef[:, i, 2, None] for i in range(3)]
    inv_len = 1.0 / torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    d = torch.stack([c * inv_len for c in r], dim=-1).reshape(-1, 3)
    o = origin.to(dt)[:, None, :].expand(-1, pixels.shape[1], 3)
    return o.reshape(-1, 3).contiguous(), d


def trace(sc: Scene, render: dict, o, d, pix, n_pix: int):
    """Radiance of the ray trees of N primary rays, summed per pixel
    ``pix`` (N,) into (n_pix, 3) float64, and the counts of rays traced,
    hits and misses."""
    dt, dev = sc.dtype, o.device
    ior = _f32(render["ior"])
    r0 = _f32(render["fresnel_r0_base"] * render["fresnel_r0_base"])
    scale = _f32(np.float32(r0) * (np.float32(1.0) - np.float32(r0)))
    eta_out = _f32(np.float32(1.0) / np.float32(ior))
    acc = torch.zeros(n_pix, 3, dtype=torch.float64, device=dev)
    w = torch.ones(o.shape[0], dtype=dt, device=dev)
    outside = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    stats = {"rays": 0, "hits": 0, "misses": 0}
    count = 0
    while o.shape[0] and count <= render["max_refract_depth"]:
        primary = count == 0
        tmin = render["primary_tmin" if primary else "secondary_tmin"]
        tmax = render["primary_tmax" if primary else "secondary_tmax"]
        hit, t, u, v, idx = closest_hit(sc, o, d, outside, tmin, tmax)
        stats["rays"] += int(o.shape[0])
        stats["hits"] += int(hit.sum())
        stats["misses"] += int(o.shape[0]) - int(hit.sum())
        miss = ~hit & (w > 0)
        acc.index_add_(0, pix[miss],
                       (w[miss, None] * env_texel(sc, d[miss])).double())
        if count == render["max_refract_depth"]:
            break  # hits at the cap add black (hlsl:82)
        o, d, w, outside, pix = o[hit], d[hit], w[hit], outside[hit], pix[hit]
        t, u, v, idx = t[hit], u[hit], v[hit], idx[hit]
        nrm = (sc.n0[idx] + u[:, None] * sc.dn1[idx]
               + v[:, None] * sc.dn2[idx])
        nrm = nrm / torch.sqrt(_dot(nrm, nrm))[:, None]
        nrm = torch.where(outside[:, None], nrm, -nrm)
        hp = o + t[:, None] * d
        cosi = _dot(d, nrm)
        base = 1.0 - cosi
        fres = scale * (base * base) * (base * base) * base
        eta = torch.where(outside, torch.full_like(cosi, eta_out),
                          torch.full_like(cosi, ior))
        k = 1.0 - eta * eta * (1.0 - cosi * cosi)
        ok = k >= 0
        coef = eta * cosi + torch.sqrt(torch.clamp(k, min=0.0))
        tr = eta[:, None] * d - coef[:, None] * nrm
        tlen = torch.sqrt(_dot(tr, tr))
        tr = tr / torch.where(tlen > 0, tlen, torch.ones_like(tlen))[:, None]
        kids = [(hp[ok], tr[ok], (w * (1.0 - fres))[ok], ~outside[ok],
                 pix[ok])]
        if count < render["max_reflect_depth"]:
            f = d - (2.0 * cosi)[:, None] * nrm
            f = f / torch.sqrt(_dot(f, f))[:, None]
            kids.append((hp, f, w * fres, outside, pix))
        o, d, w, outside, pix = (torch.cat([kid[j] for kid in kids])
                                 for j in range(5))
        count += 1
    return acc, stats


def render_views(sc: Scene, render: dict, angles, pixels,
                 max_rays: int = 1 << 18):
    """(V, K, 3) float64 radiance of the flat pixel ids ``pixels`` (V, K)
    (row-major, y major) seen from the V orbit ``angles``, traced in blocks
    of views of at most ``max_rays`` primary rays, and the summed counts of
    rays traced, hits and misses."""
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=sc.a.device)
    n_views, k = pixels.shape
    out = torch.zeros(n_views, k, 3, dtype=torch.float64,
                      device=pixels.device)
    stats = {"rays": 0, "hits": 0, "misses": 0}
    offsets = sample_offsets(render["spp"])
    step = max(1, max_rays // max(k, 1))
    for v0 in range(0, n_views, step):
        ids = pixels[v0:v0 + step]
        slot = torch.arange(ids.numel(), device=ids.device)
        for off in offsets:
            o, d = primary_rays(sc, render, angles[v0:v0 + step], ids, off)
            acc, st = trace(sc, render, o, d, slot, ids.numel())
            out[v0:v0 + step] += acc.reshape(ids.shape[0], k, 3)
            for key in stats:
                stats[key] += st[key]
    return out / len(offsets), stats


def display_u8(radiance: torch.Tensor) -> torch.Tensor:
    """The display transform: clamp to [0, 1], gamma 1/2.2, to 8 bits
    rounding half up."""
    disp = torch.clamp(radiance.double(), 0.0, 1.0) ** (1.0 / 2.2)
    return torch.floor(disp * 255.0 + 0.5).to(torch.uint8)
