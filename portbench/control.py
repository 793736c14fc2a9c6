#!/usr/bin/env python3
"""The control of a cell's `correct`: the plain reference put in the
program's place, computed with TF32 on for its float32 matmuls (the
precision below the configuration's float32 with TF32 off), at the cell's
channel count, held to the cell's limits against the reference itself on
the sample that a run checks. It has to come out as not correct. The
benchmark's own runs do not run it.

    python3 portbench/control.py --workload <name> --seeds a,b,c [--ticks 500]

Prints one JSON line per seed with the numbers compared; on the card only
(TF32 exists there alone).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run as harness  # noqa: E402
from portbench.traffic import generator  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--channels", type=int, default=None)
    args = ap.parse_args(argv)
    overrides = {} if args.channels is None else {"channels": args.channels}
    _, config, traffic, _, _ = harness.load_cell(args.workload, overrides)
    channels = int(traffic.get("channels", config["channels"]))
    codec, soft, carry = config["codec"], bool(config["soft"]), bool(config["carry_enh"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = generator.make_pool(codec, channels, traffic, seed, "cuda")
        bits = generator.pack(pool.bits) if traffic["entry"] != "batch" else pool.bits
        rel = pool.rel if soft else None
        seeds = pool.seeds.cpu().numpy()
        sample = harness.sample_of(seed, channels, traffic)
        index = torch.as_tensor(sample, device=bits.device)
        got_pcm, got_words = harness.reference_outputs(
            codec, soft, carry, bits, rel, seeds, "cuda", args.ticks, keep=sample, tf32=True)
        ref_pcm, ref_words = harness.reference_outputs(
            codec, soft, carry, bits.index_select(1, index),
            None if rel is None else rel.index_select(1, index), seeds[sample], "cuda",
            args.ticks)
        checks, failed, facts = harness.compare(config["limits"], ref_pcm, ref_words, got_pcm,
                                                got_words)
        row = {"workload": args.workload, "seed": seed, "channels": channels,
               "ticks": args.ticks, "correct": all(v <= lim for v, lim in checks.values()),
               "failed": failed, "checks": {k: v for k, (v, _) in checks.items()}, **facts}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del pool, bits, rel
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
