"""
The benchmark of ``riptide_tpu_torch`` on CUDA cards: one run of one
cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (DM trials), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit; the same numbers end standard error.
Exits 2 without a result where there is no CUDA card, or fewer than the
cell asks for, and 3 where a module of JAX or of the JAX package was
loaded. Build and kernel caches live in ``.riptide_cache/`` of the
checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_env(root):
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, ".riptide_cache")
    os.environ["RIPTIDE_CACHE_ROOT"] = cache
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")


def _power_limit():
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=10.0)
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"
    return out.stdout.strip() or "power limit not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env(ROOT)

    import torch

    from . import cell, check

    wl, cfg, mix, limits, bench = cell.load_cell(args.workload)
    need = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(0, device=device)
    print(f"imports and the card's context: "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr,
          flush=True)
    result, lines = cell.run_cell(wl, cfg, mix, limits, bench, args.seed,
                                  args.seconds, bool(args.trace), device,
                                  T_START)
    print(f"device: {_power_limit()}", file=sys.stderr, flush=True)
    bad = check.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules the run may not hold: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
