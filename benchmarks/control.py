"""The control of a cell's comparison, on a few seeds: it has to fail the
limits that the program passes.

For a serve cell, the cell runs, and its sample is compared twice with the
plain reference: once judging the tokens the program served, once the
tokens that the reference computed in fp8 (one precision step below the
configuration's bfloat16) puts first at the same positions. For a train
cell, the program's train step runs its compared steps in this process
(the worker's code, without the runtime: these readings need no window),
then the float32 reference and the reference computed in fp8 follow them
on the seed's batches; ``--fault`` plants a fault in the program's steps
(``train.FAULTS``), to read it at the cell's size.

    python3 -m benchmarks.control --workload <cell> --seeds 1,2,3 \\
        --seconds 20

prints one JSON line per seed with the readings. It runs on the card only,
as ``run.py`` does; ``benchmarks/tests`` holds it at a tiny size."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from benchmarks import harness
from benchmarks.drivers.train import FAULTS


def readings(cell: harness.Cell, seed: int, seconds: float,
             device: str = "cuda",
             fault: Optional[str] = None) -> Dict[str, Any]:
    """The control's readings on one seed (and, for a serve cell, the
    program's on the same sample). For a train cell, ``fault`` plants one
    of ``train.FAULTS`` in the program's compared steps."""
    if cell.driver == "train":
        from benchmarks.drivers import train

        config = train.loop_config(cell, seed, seconds, False, device)
        prog = train.program_readings(config, device, fault=fault)
        routing = prog.get("routing")
        want = train.reference_readings(config, device, routing=routing)
        ctl = train.compare(train.reference_readings(
            config, device, quant="fp8", routing=routing), want)
        return {"seed": seed, "program": train.compare(prog, want),
                "control": ctl}
    from benchmarks.drivers import serve

    fig = serve.run(cell, seed, seconds, trace=False, device=device)
    ctl = serve.compare(fig["sample"], fig["sizes"], seed, fig["lora_rank"],
                        device, quant="fp8", dtype=fig["dtype"])
    return {"seed": seed, "program": fig["compared"], "control": ctl,
            "end_to_end": fig["end_to_end"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="a train cell's planted fault")
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.resolve_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds,
                                  fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
