"""One run of one benchmark cell of the PyTorch/CUDA port (``hippie_tpu_torch``).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads and warms the cell (set-up), measures
for ``--seconds``, checks what the timed path produced against the plain
reference (``perfbench/reference/``), and prints one JSON line last on
stdout: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number that decides ``correct`` beside its limit (also
the last lines of stderr). The cell's files are found by name (see
``harness/common.py``): the mix's ``kind`` names the runner,
``perfbench/traffic/<kind>.py``, and each metric's reader is
``perfbench/metrics/<metric>.py``.

It exits 1 without a result when no CUDA device is there, or fewer than the
cell asks for, and 1 when the run loaded JAX or the JAX package.

Options that the benchmark's own runs never pass:
- ``--device cpu``: a rehearsal of the cell's control flow at the tiny sizes
  its configuration and traffic files give under ``rehearsal``; it prints
  ``correct`` and the compared numbers, and no metric and no device;
- ``--control 1``: also the numbers of the reference computed one precision
  below the configuration's (``reference/numerics.py``), under ``control``;
- ``--fault <name>``: the timed path broken underneath (train cells:
  ``frozen``, ``half_batch``; embedding cells: ``altered``, ``half_rows``),
  for the tests that see ``correct`` come out false.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from perfbench.harness import common  # noqa: E402

T_START = common.process_start()


def build_parser():
    p = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    return p


class Ctx:
    def __init__(self, args, cell, device):
        self.cell, self.device = cell, device
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.control, self.fault = bool(args.control), args.fault
        self.rehearsal = device.type != "cuda"
        self.t_start = T_START


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.set_cache_dirs()
    cell = common.Cell(args.workload)
    import torch

    if args.device == "cuda":
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            common.log(f"needs {chips} CUDA device(s): torch.cuda.is_available() is "
                       f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}")
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(2)
    from hippie_tpu_torch.ops import _build

    _build.set_default_dir(str(common.CACHE_DIR))
    runner = cell.runner()
    if args.fault is not None and args.fault not in runner.FAULTS:
        raise SystemExit(f"perfbench: --fault is one of {runner.FAULTS} for this cell")
    out = runner.run(Ctx(args, cell, device))
    if out["found"]:
        common.log(f"the run loaded {', '.join(out['found'])}: the benchmark measures the port alone")
        return 1
    ok, compared = common.judge(out["numbers"], cell.limits)
    ok = ok and out["failed"] == 0
    line = {"correct": ok, "attempted": out["attempted"], "failed": out["failed"]}
    if device.type != "cuda":
        line["rehearsal"] = True  # the readers run, and no device metric is printed
        if _metrics(cell, out["run"], False) is None:
            return 1
        _metrics(cell, out["run"], True)
    else:
        metrics = _metrics(cell, out["run"], bool(args.trace))
        if metrics is None:
            return 1
        line["metrics"] = metrics
        line["device"] = dict(out["device"])
        if args.trace:
            prof = out["run"]["prof"]
            line["device"]["busy_s"] = prof["busy_s"]
            line["device"]["window_s"] = prof["span_s"]
            line["breakdown"] = {"device_ops": prof["trace"].top_ops(10), "idle_gaps": prof["gaps"]}
    line["readings"] = out["numbers"]
    if out["control"] is not None:
        line["control"] = out["control"]
        common.log(f"control {json.dumps(out['control'])}")
    if args.fault is not None:
        line["fault"] = args.fault
    common.emit(line, compared)
    return 0


def _metrics(cell, run: dict, trace: bool):
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``), each from its reader over the runner's counts. A
    per-layer reader with nothing to read leaves its metric out; an
    end-to-end metric with no reading is a fault of the run (None)."""
    out = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.reader(m["name"])(run)
        if value is None and not trace:
            common.log(f"the run gave no reading of the end-to-end metric {m['name']}")
            return None
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
