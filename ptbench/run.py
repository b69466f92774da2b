"""Run one cell of the benchmark of `pathtracer_tpu_torch` once.

    python3 ptbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`ptbench/configs/<config>/scene.json`) and a traffic mix
(`ptbench/traffic/<traffic>.json`). The run builds the scene on the card
through the program's own builder, renders one warm-up frame (set-up),
then renders frames in a closed loop for `--seconds`: each frame one call
of the traffic's renderer entry with a generator seeded from `--seed` and
the frame's index, then its film copied to the host. After the window it
reads the metrics (each one `ptbench/metrics/<name>.py`), frees the
program's state, renders the plain reference (`ptbench/reference/`) and
compares (`check.py`, limits in `ptbench/limits/<workload>.json`).

With `--trace 1` the window runs under torch.profiler, tracing the device
alone, with the program's own recorder on (its spans and counters,
`pathtracer_tpu_torch.utils.profile.tracing()`, read by `spans`), and the
result carries the per-layer metrics, `busy_s`, `window_s` and a
`breakdown`; with `--trace 0` the end-to-end metrics, the recorder off.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, [breakdown], checks); the numbers compared are
also the last lines of standard error. Without a CUDA card the run exits
2 and prints no result; if JAX or the JAX package was loaded, 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")
MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def derive_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit generator seed for (run seed, stream, index)."""
    return _mix(_mix(_mix(seed & MASK64) ^ stream) ^ index) >> 1


FRAME, WARMUP, REFERENCE, CONTROL = 1, 2, 3, 4


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def log(msg):
    print(f"ptbench: {msg}", file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_metric(name: str):
    """`ptbench/metrics/<name>.py`'s module."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"ptbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload's entries, found by name."""

    def __init__(self, bench: dict, workload: str, traffic=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        self.config = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.traffic = traffic or load_json(
            HERE, "traffic", f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE, "limits", f"{workload}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.config_dir = os.path.join(ROOT,
                                       os.path.dirname(self.config["file"]))


class Run:
    """What a window leaves for the metric readers: the frames (their host
    spans, route, rounds and counters), the window and set-up seconds, the
    peak memory, and with a trace the device spans on the host clock and
    the program's own spans and counter totals (`spans.attach`)."""

    def __init__(self, traffic):
        self.traffic = traffic
        self.samples_per_frame = (traffic["width"] * traffic["height"]
                                  * traffic["samples"])
        self.frames = []
        self.window_start = self.window_s = self.setup_s = 0.0
        self.build_s = 0.0  # the kernel library's build or load, in setup_s
        self.peak_bytes = self.device_peak_bytes = 0
        self.device_spans = None  # [(start s, end s, name)] or None
        self.program_spans = None  # [(start s, end s, name, parent, render)]
        self.program_counters = None  # {name: total}


def frame(render, world, camera, settings, traffic, seed, device):
    """One frame: the entry's call and the film's copy to the host."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    stats = {}
    t_call = time.perf_counter()
    film, prof, _ = render(world, camera, settings, traffic["width"],
                           traffic["height"], traffic["samples"], generator=g,
                           stats=stats,
                           use_megakernel=traffic.get("use_megakernel"))
    t_return = time.perf_counter()
    host = film.cpu().numpy()
    t_host = time.perf_counter()
    return host, dict(t_call=t_call, t_return=t_return, t_host=t_host,
                      route=stats.get("route"), rounds=stats.get("rounds"),
                      counters=dict(vars(prof)),
                      total_rays=prof.total_rays)


def run_window(cell: Cell, seed: int, seconds: float, trace: bool, device,
               t_start: float = T_START, render=None, max_frames=None):
    """Set-up, warm-up and the window -> (Run, films, data). The window
    ends with the frame that passes `seconds`, or `max_frames` (tests)."""
    import torch

    from ptbench import port
    from ptbench.reference import loader

    tr = cell.traffic
    cuda = torch.device(device).type == "cuda"
    build_s = 0.0
    if cuda:
        t0 = time.perf_counter()
        port.load_kernels()
        build_s = time.perf_counter() - t0
    data = loader.load(cell.config_dir, ROOT)
    world, camera = port.build_scene(data, tr["width"], tr["height"], device)
    settings = port.settings(tr)
    render = render or port.entry(tr)
    frame(render, world, camera, settings, tr,
          derive_seed(seed, WARMUP), device)
    if cuda:
        torch.cuda.synchronize()
    run = Run(tr)
    run.setup_s = time.perf_counter() - t_start
    run.build_s = build_s
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    films = []

    def loop():
        run.window_start = w0 = time.perf_counter()
        i = 0
        while True:
            host, rec = frame(render, world, camera, settings, tr,
                              derive_seed(seed, FRAME, i), device)
            films.append(host)
            run.frames.append(rec)
            i += 1
            if rec["t_host"] - w0 >= seconds or i == max_frames:
                break
        run.window_s = run.frames[-1]["t_host"] - w0

    if trace:
        from pathtracer_tpu_torch.utils import profile
        from ptbench import spans, tracing

        recorded = []

        def recorded_loop():
            if profile.recorder() is not None:
                # a caller records around the window itself (tools/
                # trace_cell.py), and recorders do not nest
                return loop()
            with profile.tracing() as rec:
                loop()
            recorded.append(rec)

        run.device_spans = tracing.traced(recorded_loop, run)
        for rec in recorded:  # the device is done: traced synchronised
            spans.attach(run, rec.resolve())
    else:
        loop()
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    run.device_peak_bytes = max(run.peak_bytes, setup_peak)
    del world, camera
    if cuda:
        torch.cuda.empty_cache()
    return run, films, data


def metric_values(cell: Cell, run: Run, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_metric(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# what a traffic mix may say: its top-level keys, and the settings of each
# integrator that the reference renders as the program does (the LT
# strata change how the program samples, not what it estimates)
TRAFFIC_KEYS = {"why", "integrator", "entry", "use_megakernel",
                "sample_counter", "bounce_counters", "width", "height",
                "samples", "settings", "check"}
SETTINGS = {"pt": {"max_bounces", "min_bounces", "light_samples",
                   "russian_roulette", "hwss", "medium_aware"},
            "lt": {"max_bounces", "min_bounces", "camera_samples",
                   "russian_roulette", "stratified", "strata_uv",
                   "strata_lam"}}


def reference_settings(traffic):
    """The reference's (render, Settings) of a traffic mix. Raises
    NotImplementedError on whatever the traffic says that the reference
    does not model, rather than render without it."""
    from ptbench.reference import lt, pt

    unknown = sorted(set(traffic) - TRAFFIC_KEYS)
    if unknown:
        raise NotImplementedError(f"traffic keys the harness does not "
                                  f"take: {unknown}")
    kind, s = traffic["integrator"], traffic["settings"]
    if kind not in SETTINGS:
        raise NotImplementedError(f"integrator {kind!r}")
    unknown = sorted(set(s) - SETTINGS[kind])
    if unknown:
        raise NotImplementedError(f"{kind} settings the reference does not "
                                  f"model: {unknown}")
    if s.get("hwss"):
        raise NotImplementedError("the reference traces one wavelength a "
                                  "path")
    if kind == "pt":
        return pt.render, pt.Settings(
            s["max_bounces"], s["min_bounces"], s["light_samples"],
            s["russian_roulette"], bool(s.get("medium_aware", False)))
    return lt.render, lt.Settings(s["max_bounces"], s["min_bounces"],
                                  s["camera_samples"], s["russian_roulette"])


def reference_side(data, traffic, seed, device, dtype=None, frames=None):
    """The plain reference's side of the comparison: `reference_batches`
    batches of the check's `reference_spp` in all, or with `frames` that
    many frames at the traffic's own samples (the control)."""
    import torch

    from ptbench import check
    from ptbench.reference import pt

    c = traffic["check"]
    render, settings = reference_settings(traffic)
    scene = pt.Scene(data, device, dtype or torch.float32)
    if frames is None:
        n, spp = c["reference_batches"], c["reference_spp"] \
            // c["reference_batches"]
        g = torch.Generator(device=device).manual_seed(
            derive_seed(seed, REFERENCE))
    else:
        n, spp = frames, traffic["samples"]
        g = torch.Generator(device=device).manual_seed(
            derive_seed(seed, CONTROL))
    key = traffic.get("sample_counter", "camera_rays")
    names = {"bounce_rays", *traffic.get("bounce_counters", {}).values()}
    side = check.Side(spp)
    for _ in range(n):
        film, cnt = render(scene, traffic["width"], traffic["height"], spp,
                           settings, g)
        side.add(film.cpu().numpy(), c["grid"], {k: cnt[k] for k in names},
                 cnt[key])
    return side


def bounce_counter(traffic, route) -> str:
    """The reference's counter that counts bounce rays as the program's
    `route` does (traffic's `bounce_counters`; `bounce_rays` by default)."""
    return traffic.get("bounce_counters", {}).get(route, "bounce_rays")


def program_side(run: Run, films):
    from ptbench import check

    side = check.Side(run.traffic["samples"])
    key = run.traffic.get("sample_counter", "camera_rays")
    for film, rec in zip(films, run.frames):
        side.add(film, run.traffic["check"]["grid"],
                 {bounce_counter(run.traffic, rec["route"]):
                  rec["counters"]["bounce_rays"]}, rec["counters"][key])
    return side


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, render=None, max_frames=None) -> dict:
    """One run of a cell -> the result's fields (without `device`'s card
    fields). `render` replaces the traffic's entry (the tests' faults)."""
    from ptbench import check

    run, films, data = run_window(cell, seed, seconds, trace, device, t_start,
                                  render, max_frames)
    routes = sorted({(f["route"], f["rounds"]) for f in run.frames},
                    key=str)
    log(f"set-up {run.setup_s:.3f} s (the kernel library's build or load "
        f"{run.build_s:.3f} s), {len(run.frames)} frames in "
        f"{run.window_s:.3f} s; (route, rounds): {routes}")
    metrics = metric_values(cell, run, trace)
    t0 = time.perf_counter()
    prog = program_side(run, films)
    del films
    t1 = time.perf_counter()
    ref = reference_side(data, cell.traffic, seed, device)
    log(f"program side {t1 - t0:.3f} s, reference "
        f"{time.perf_counter() - t1:.3f} s")
    values = check.readings(prog, ref, run.samples_per_frame)
    correct, checks = check.judge(values, cell.limits)
    out = dict(correct=correct, attempted=len(run.frames),
               failed=check.failed_frames(prog, ref, cell.limits),
               metrics=metrics, run=run, checks=checks)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    cache = os.path.join(ROOT, ".ptbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ptbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    run = out.pop("run")
    found = forbidden_modules()
    if found:
        print(f"ptbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=chips, memory_peak_bytes=int(run.device_peak_bytes),
                  build_s=run.build_s)
    result = dict(correct=out["correct"], attempted=out["attempted"],
                  failed=out["failed"], metrics=out["metrics"], device=device)
    if args.trace:
        from ptbench import spans, tracing

        device["busy_s"] = tracing.busy_seconds(run.device_spans)
        device["window_s"] = run.window_s
        result["breakdown"] = tracing.breakdown(run)
        if run.program_spans:
            fixed = spans.anchored(run)
            log(f"clock check {spans.clock_check(run)!r} (anchored: "
                f"{spans.clock_check(fixed) if fixed else None!r}), host - "
                f"device at the anchors {spans.clock_offsets_us(run)!r} us, "
                f"program spans inside their calls "
                f"{spans.inside_calls(run)!r}")
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
