"""One run of one cell: set-up, the measured window, the check, the trace.

The window drives the program's own frame path, calling it as
``python -m refraction_tpu_torch.run`` does (`run.main`'s loop, without
its PNG encode, whose loop body cannot be called on its own):

- set-up builds the scene from the benchmark's inputs
  (`scene.build_scene` at `scene.auto_cluster_size`, or for a scene of
  placed instances `scene.build_instanced_scene`; uploaded by
  `scene.scene_from_jax`), logs the walk the frame kernel takes over it
  (`framekernel.walk_levels`) with its triangles and visible instances,
  and builds the renderer (`render.make_renderer` with
  backend ``cuda``: `build_scalars` and one `fused_radiance` launch,
  ``rt_frame``, a frame), then warms the loop up;
- each frame takes its pose from `camera.orbit_camera` at an angle that
  advances by the configuration's ``orbit_speed``, renders, and queues its
  copy to the host through `run.HostCopies` (the u8 display image from
  `run.to_u8`, or the float radiance);
- at depth 2 (``orbit``, ``accumulate``) frame i + 1 is enqueued before the
  host waits for frame i's copy event; at depth 1 (``sync``) each frame is
  waited for before the next pose;
- ``accumulate`` folds each delivered radiance into a
  `render.Accumulator`.

With ``trace`` the same window runs with ``record_function`` spans around
each call into the program and `torch.profiler` records a bounded slice
of it (`TRACE_SKIP_S` into the window, about `TRACE_S` long).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import subprocess
import sys
import time

import numpy as np
import torch

from rtbench import check, inputs, roofline, trace as trace_mod
from rtbench.reference import tracer
from rtbench.spec import Cell, load_reader

# The JAX side of the repository, which no run may load: jax, jaxlib, flax
# and the JAX package (oracle/ imports it), by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "refraction_tpu", "oracle")
# The traced slice: frames skipped into the window, then the profiler's
# own warm-up steps, then about TRACE_S of frames (within the bounds).
TRACE_SKIP_S = 1.0
TRACE_WARM_STEPS = 3
TRACE_S = 0.5
TRACE_FRAMES = (20, 400)
# The fewest frames a window delivers, however short its seconds.
MIN_FRAMES = 8


def render_config(render: dict):
    """The program's `RenderConfig` of a configuration's ``render`` block
    (``pi_camera`` is the program's constant and is not a field)."""
    from refraction_tpu_torch.config import RenderConfig

    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**{k: v for k, v in render.items() if k in fields})


class Program:
    """The system under test, built at set-up from the seed's inputs.

    A configuration's ``mesh`` is built by `scene.build_scene` at
    `scene.auto_cluster_size`; its ``scene`` of placed instances by
    `scene.build_instanced_scene`, which picks the cluster size, from one
    `MeshData` a named mesh shared by its instances (as
    `scene.load_instanced` shares one a path). ``mesh`` or ``placed`` (the
    named meshes and the instances) keeps what the reference is made from
    after the window."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        from refraction_tpu_torch.io.objmesh import MeshData
        from refraction_tpu_torch.render import make_renderer
        from refraction_tpu_torch.scene import (
            Instance, auto_cluster_size, build_instanced_scene, build_scene,
            scene_from_jax)

        self.mesh = self.placed = None
        env = config["env"]
        if "scene" in config:
            self.placed = inputs.make_instances(config["scene"])
            self.env = inputs.make_env(seed, env["height"], env["width"],
                                       device)
            meshes, placed = self.placed
            data = {name: MeshData(*m) for name, m in meshes.items()}
            host, meta = build_instanced_scene(
                [Instance(data[name], m, mask) for name, m, mask in placed],
                self.env.cpu().numpy(), None)
            self.visible = inputs.visible_counts(*self.placed)[1]
        else:
            self.mesh = inputs.make_mesh(config["mesh"])
            self.env = inputs.make_env(seed, env["height"], env["width"],
                                       device)
            host, meta = build_scene(MeshData(*self.mesh),
                                     self.env.cpu().numpy(),
                                     auto_cluster_size(self.mesh[0].shape[0]))
            self.visible = 1
        self.num_tris = meta.num_real_tris
        self.scene = scene_from_jax(host, device)
        self.cfg = render_config(config["render"])
        self.renderer = make_renderer(self.cfg, "cuda", device)

    def scene_line(self) -> str:
        """The walk the frame kernel takes over this scene, and its
        counts."""
        from refraction_tpu_torch.kernels.framekernel import walk_levels

        lv = walk_levels(self.scene)
        return (f"scene: walk={lv['walk']}: {lv['roots']} roots, "
                f"{lv['supers']} supers, {lv['clusters']} clusters, "
                f"{lv['subs_per_cluster']} subs a cluster; {self.num_tris} "
                f"tris, {self.visible} visible instances")


def reference_scenes(mesh, placed, env: torch.Tensor, device,
                     control: bool):
    """The reference's scene (and with ``control`` the control's, in
    bfloat16) of a configuration's ``mesh``, or of its ``placed``
    instances baked by rtbench itself (`inputs.bake_instances`), with
    their ranges and boxes for the cull."""
    inst = None
    if placed is not None:
        pos, nrm, ranges, boxes = inputs.bake_instances(*placed)
        mesh, inst = (pos, nrm), (ranges, boxes)
    sc = tracer.Scene(mesh[0], mesh[1], env, device, instances=inst)
    ctl = (tracer.Scene(mesh[0], mesh[1], env, device, torch.bfloat16,
                        instances=inst) if control else None)
    return sc, ctl


@dataclasses.dataclass
class Records:
    """What the loop saw, frame by frame."""

    angles: list = dataclasses.field(default_factory=list)
    t_pose: list = dataclasses.field(default_factory=list)
    t_done: list = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)


def _span(on: bool, name: str):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def loop(prog: Program, traffic: dict, copies, angle0: float, stop,
         pixel_sets: np.ndarray | None = None, acc=None, prof=None,
         spans: bool = False) -> Records:
    """Frames until ``stop(frames enqueued, now)``; each delivered frame's
    pixels at its pixel set are kept (``pixel_sets``), or its radiance is
    folded into ``acc``."""
    from refraction_tpu_torch.camera import orbit_camera

    depth = int(traffic["depth"])
    if depth not in (1, 2):
        raise ValueError(f"traffic depth {depth}: the loop runs 1 or 2 deep "
                         "(run.HostCopies has two slots)")
    rec = Records()
    clock = time.perf_counter

    def drain(entry):
        i, u8, rad, done = entry
        with _span(spans, "rtbench.wait"):
            if done is not None:
                done.synchronize()
        rec.t_done.append(clock())
        if acc is not None:
            with _span(spans, "rtbench.fold"):
                acc.add(rad)
        elif pixel_sets is not None:
            with _span(spans, "rtbench.sample"):
                rec.samples.append(
                    u8.reshape(-1, 3)[pixel_sets[i % len(pixel_sets)]])

    pending = None
    angle = angle0
    i = 0
    while True:
        now = clock()
        if stop(i, now):
            break
        with _span(spans, trace_mod.FRAME_SPAN):
            with _span(spans, "rtbench.pose"):
                frame = orbit_camera(angle, prog.cfg)
            with _span(spans, "rtbench.render"):
                img = prog.renderer(prog.scene, frame)
            with _span(spans, "rtbench.enqueue"):
                u8, rad, done = copies.enqueue(img)
            rec.angles.append(angle)
            rec.t_pose.append(now)
            entry = (i, u8, rad, done)
            if depth == 2:
                entry, pending = pending, entry
            if entry is not None:
                drain(entry)
        if prof is not None:
            prof.step()
        angle += prog.cfg.orbit_speed  # RefractionDemo.cpp:567, run.main
        i += 1
    if pending is not None:
        drain(pending)
    return rec


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({type(e).__name__})"
    return out.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    numbers: dict
    limits: dict
    lines: list
    breakdown: dict | None = None
    card: str = ""
    control_numbers: dict | None = None

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device, "card": self.card}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = {k: {"value": v, "limit": self.limits.get(k)}
                         for k, v in self.numbers.items()}
        return out


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log=print,
        control: bool = False) -> Result:
    """One run of ``cell``: set-up from ``t_start`` (the process's start
    on the host clock), the window of ``seconds``, the check, and with
    ``trace`` the per-layer metrics. ``log`` takes progress lines. With
    ``control`` the result also holds the control's numbers: the reference
    in bfloat16 in the program's place, at the same frames and pixels."""
    from refraction_tpu_torch.render import Accumulator
    from refraction_tpu_torch.run import HostCopies

    config, traffic = cell.config, cell.traffic
    render = config["render"]
    kind = traffic["check"]
    prog = Program(config, seed, device)
    log(prog.scene_line())
    # The u8 display image for the u8 check, the float radiance to fold.
    copies = HostCopies(device, u8=kind == "u8", radiance=kind != "u8",
                        linear=False)
    k = check.PIXELS
    n_px = render["width"] * render["height"]
    pick = inputs.rng(seed, inputs.STREAM_PIXELS)
    if kind == "u8":
        pixel_sets = np.stack([pick.choice(n_px, size=k, replace=False)
                               for _ in range(check.PIXEL_SETS)])
    else:
        pixel_sets = pick.choice(n_px, size=k, replace=False)[None]

    def accumulator():
        if kind != "accumulate":
            return None
        return Accumulator(render["height"], render["width"])

    # Warm-up: the window's own loop, the same shapes, copies and slots,
    # folding into an accumulator of its own.
    warm_n = int(traffic["warmup_frames"])
    angle0 = inputs.start_angle(seed)
    t_w = time.perf_counter()
    loop(prog, traffic, copies, angle0, lambda i, now: i >= warm_n,
         pixel_sets, accumulator())
    _sync(device)
    period = (time.perf_counter() - t_w) / warm_n
    acc = accumulator()

    prof = None
    traced = {}
    need = mid = 0  # frames the trace needs; the middle traced frame
    if trace:
        skip = math.ceil(TRACE_SKIP_S / period)
        active = min(max(math.ceil(TRACE_S / period), TRACE_FRAMES[0]),
                     TRACE_FRAMES[1])
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)

        def ready(p):
            traced["trace"] = trace_mod.from_events(p.events())

        prof = torch.profiler.profile(
            activities=acts, on_trace_ready=ready,
            schedule=torch.profiler.schedule(
                wait=skip, warmup=TRACE_WARM_STEPS, active=active, repeat=1))
        need = skip + TRACE_WARM_STEPS + active
        mid = skip + TRACE_WARM_STEPS + active // 2

    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        deadline = t0 + seconds
        rec = loop(prog, traffic, copies, angle0,
                   lambda i, now: now >= deadline and i >= max(need,
                                                               MIN_FRAMES),
                   pixel_sets, acc, prof, spans=trace)
    _sync(device)
    setup_s = t0 - t_start
    found = forbidden_modules()
    if found:
        raise RuntimeError("the run loaded " + ", ".join(found)
                           + ": the benchmark measures the PyTorch port alone")

    n = len(rec.t_done)
    window = rec.t_done[-1] - rec.t_pose[0]
    lat = np.asarray(rec.t_done) - np.asarray(rec.t_pose)
    # An end-to-end metric's value by its name's first part: the cells
    # whose frame kernel sets the pace report frame_ms as
    # frame_ms.kernel_paced, a metric with its own bound.
    e2e = {
        "frame_ms": window / n * 1e3,
        "frame_latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "msamples_per_s": (render["width"] * render["height"]
                           * render["spp"] * n / window / 1e6),
        "setup_s": setup_s,
    }
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if device.type == "cuda" else 0}
    log(f"window {window:.3f} s, {n} frames, setup {setup_s:.3f} s")

    # The check, once the program's state is freed.
    acc_sum = (acc.sum.reshape(-1, 3)[pixel_sets[0]].copy()
               if acc is not None else None)
    acc_count = acc.count if acc is not None else 0
    mesh, placed, env = prog.mesh, prog.placed, prog.env
    del prog, copies, acc
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    sc, ctl = reference_scenes(mesh, placed, env, device, control)
    control_numbers = None
    if kind == "u8":
        chosen = frames_to_check(seed, n, check.CHECK_FRAMES)
        args = ([rec.angles[i] for i in chosen], torch.as_tensor(
            pixel_sets[[i % len(pixel_sets) for i in chosen]], device=device))
        expected = check.reference_u8(sc, render, *args)
        numbers = check.u8_numbers(
            np.stack([rec.samples[i] for i in chosen]), expected)
        if ctl is not None:
            control_numbers = check.u8_numbers(
                check.reference_u8(ctl, render, *args), expected)
    else:
        args = (rec.angles[:n], torch.as_tensor(pixel_sets[0], device=device))
        expected = check.reference_sum(sc, render, *args)
        numbers = check.acc_numbers(acc_sum, acc_count, n, expected)
        if ctl is not None:
            control_numbers = check.acc_numbers(
                check.reference_sum(ctl, render, *args), n, n, expected)
    log(f"check {time.perf_counter() - t_c:.3f} s")
    ok, lines = check.verdict(numbers, cell.limits or {})

    result = Result(correct=ok, attempted=len(rec.t_pose),
                    failed=len(rec.t_pose) - n, metrics={}, device=dev,
                    numbers=numbers, limits=cell.limits or {}, lines=lines,
                    card=card_line() if device.type == "cuda" else "cpu",
                    control_numbers=control_numbers)
    if not trace:
        for m in cell.end_to_end:
            result.metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                         "unit": m["unit"]}
        return result

    tr = traced.get("trace")
    ctx = {"trace": tr, "roofline": None}
    if tr is not None:
        counts = roofline.ray_counts(sc, render, rec.angles[mid])
        ctx["roofline"] = roofline.bound(
            counts, sc.num_tris, render,
            instanced=inputs.visible_counts(*placed) if placed else None)
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        result.breakdown = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    for m in cell.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            result.metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return result


def frames_to_check(seed: int, n: int, m: int) -> list[int]:
    """Up to ``m`` of ``n`` delivered frames drawn from the seed, the first
    and the last among them, in order."""
    pick = inputs.rng(seed, inputs.STREAM_FRAMES)
    chosen = set(pick.choice(n, size=min(n, m), replace=False).tolist())
    chosen.update((0, n - 1))
    return sorted(chosen)
