"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, its model family's reference, traffic mix, check and
metrics by name under this folder (``lib/registry.py``), runs the mix's
driver on the cards the cell asks for, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``),
``breakdown`` with ``--trace 1``, and ``checks``, each compared number
with its limit, which are also the last lines of standard error.

Exits non-zero without a result when no CUDA card is visible, when fewer
cards are visible than the cell asks for, or when the JAX package, JAX,
jaxlib or flax was loaded. ``--control int8`` runs the program's int8
trunk in place of the configured precision: the control of ``correct``,
never run by a check.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# few threads on a host whose cores are shared: OpenMP's idle threads
# sleep at once instead of spinning on cores the pipeline's threads need
os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
HOST_THREADS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "aerial_image_recognition_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port may not load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8",), default=None)
    return p.parse_args(argv)


def cards(n: int):
    """The first ``n`` CUDA cards; SystemExit when there are fewer."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible: the benchmark runs on "
                         "the card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell asks for {n} cards, "
                         f"{torch.cuda.device_count()} are visible")
    return [torch.device("cuda", i) for i in range(n)]


def _setup_torch():
    import torch
    # the reference runs in f32: no TF32 on either side
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the host copies (the ring's staging into pinned memory) run on
    # torch's intra-op threads: two, not one a core
    torch.set_num_threads(HOST_THREADS)


def measure(args, devices=None, spec_root: str = ROOT):
    """Run the cell; returns (result line dict, [[name, value, limit]]).
    ``spec_root`` holds ``BENCHMARK.json`` and the benchmark's folder
    (the checkout; a copy in the harness's tests); ``devices`` replaces
    the cards (the CPU in those tests)."""
    from benchmark.lib import registry
    from benchmark.lib.result import Context
    spec = registry.load_spec(spec_root)
    bench_dir = os.path.join(spec_root, "benchmark")
    cell = registry.cell(spec, args.workload)
    if devices is None:
        devices = cards(cell["chips"])
    _setup_torch()
    traffic = registry.load_traffic(cell["traffic"], bench_dir)
    with open(os.path.join(bench_dir, "checks", f"{cell['name']}.json")) as f:
        check = json.load(f)
    tmp = os.path.join(tempfile.gettempdir(), "bench-" + cell["name"])
    os.makedirs(tmp, exist_ok=True)
    config = registry.load_config(spec, cell["config"], spec_root)
    ctx = Context(config=config,
                  family=registry.family(config["reference"], bench_dir),
                  traffic=traffic, check=check, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  devices=devices, root=ROOT, tmp=tmp, t_start=T_START,
                  control=args.control)
    res = registry.driver(traffic, bench_dir).run(ctx)

    from benchmark.lib.check import verdict
    correct, rows = verdict(res.numbers, check["limits"])
    metrics = {}
    if args.trace:
        for m in registry.metrics_for(spec, cell["name"], "per_layer"):
            value = registry.metric_reader(m["name"], bench_dir)(res)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.metrics_for(spec, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": res.e2e[m["name"]],
                                  "unit": m["unit"]}
    import torch
    device = {"platform": "gpu" if devices[0].type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(devices[0])
              if devices[0].type == "cuda" else "cpu",
              "count": len(devices),
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics, "device": device}
    if args.trace and res.trace is not None:
        device["busy_s"] = sum(res.trace.busy_s(c) for c in res.cards) \
            / len(res.cards)
        device["window_s"] = res.trace.window_s
        first = res.cards[0]
        line["breakdown"] = {"device_ops": res.trace.top_ops(10),
                             "idle_gaps": res.trace.idle_gaps(first, 10)}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in rows}
    info = {k: v for k, v in res.numbers.items() if k not in check["limits"]}
    info.update({k: v for k, v in res.layer.items()
                 if isinstance(v, (int, float, list))})
    print("info " + json.dumps(info), file=sys.stderr)
    return line, rows


def main(argv=None) -> int:
    args = parse(argv)
    try:
        line, rows = measure(args)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"loaded in this process, and not allowed: {found}",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
