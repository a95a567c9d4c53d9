"""The readings the limits of a serving cell are set from, at the cell's own size.

    python3 -m port_bench.control --workload <name> --seeds <a,b,...> --seconds <s> [--out <file>]

For each seed, in one process: the program's net at the seed's weights, one
warm-up step, a short window at the cell's load, then the check with the
control beside it: the reference computed with float8 e4m3 operands (the
step below the configuration's bf16) in the program's place, and for a
training cell also the reference with each loss altered by 5% where it is
produced (a planted fault). Prints, per seed and number, the program's
reading and the control's (and the fault's); the summary gives each number's
largest program reading (the lower end of its limit) and smallest control
and fault readings (the upper end). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

from port_bench.run import kind_class, load_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = load_cell(Path.cwd(), args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        runner = kind_class(spec["traffic"]["kind"])(spec["config"], spec["traffic"], torch.device("cuda:0"), seed)
        runner.warm_up()
        res = runner.window(args.seconds)
        runner.free_program()
        numbers = runner.check(control=True)
        rows.append({"seed": seed, "steps": res["units"], "numbers": numbers})
        print(json.dumps(rows[-1]), flush=True)
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    names = rows[0]["numbers"]
    summary = {n: {"program_max": max(r["numbers"][n][0] for r in rows),
                   "control_min": min(r["numbers"][n][1] for r in rows)} for n in names}
    for n in names:
        if len(rows[0]["numbers"][n]) > 2:
            summary[n]["altered_min"] = min(r["numbers"][n][2] for r in rows)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "seeds": rows, "summary": summary}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
