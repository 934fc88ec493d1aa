"""Time the unsharded decision path of this checkout against another's, on
one NVIDIA GPU, in turns (other, this, this, other), ``--rounds`` times.

    python3 tools/decision_ab.py --other DIR [--rounds 5] [--hosts 65536] [--batches 8] \
        [--singles 128]

``DIR`` is the root of another checkout of this repository (for example the
parent commit unpacked with ``git archive``).  Each turn is a fresh process
that imports ``repro_torch`` from one tree (its kernels built from that
tree's sources) and runs ``chip_smoke.py`` phase 5's workload: a
``SoAFleet`` on the card over ``fleets.saturated_fleet(hosts, seed=0)``,
requests drawn as phase 5 draws them (half normal), a warm-up batch of 16,
then ``--batches`` batches of 64 through ``schedule_batch`` and
``--singles`` single decisions through ``schedule_request``.  Each turn
prints one JSON line: decisions/s in batches, the single decisions' p50 and
p99 ms, fallbacks, and a digest of every outcome (host, victims); a last
line holds each tree's mean, least and greatest reading over its turns and
whether every digest agreed (the trees must make the same decisions).  Nothing here imports JAX
or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(args) -> None:
    """One timed run in this process, on the tree ``args.tree``."""
    import hashlib
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(args.tree, "src"))
    from repro_torch.core import fleets
    from repro_torch.core.soa_fleet import SoAFleet
    from repro_torch.core.types import Request

    if not torch.cuda.is_available():
        sys.exit("decision_ab.py: no CUDA device visible")
    fleet = SoAFleet(fleets.saturated_fleet(args.hosts, seed=0), device="cuda")
    sizes = list(fleets.SIZES.values())
    rng = np.random.default_rng(7)
    clock = [fleets.NOW]

    def batch(b, tag):
        items = []
        for i in range(b):
            clock[0] += float(rng.integers(1, 20))
            items.append((Request(id=f"{tag}{i}", resources=sizes[int(rng.integers(0, 3))],
                                  preemptible=bool(i % 2)), clock[0], 1.0))
        return items

    digest = hashlib.sha256()

    def absorb(outs):
        for o in outs:
            digest.update(repr((o.host, tuple(v.id for v in o.victims))).encode())

    fleet.schedule_batch(batch(16, "warm"))
    torch.cuda.synchronize()
    f0 = fleet.fallbacks
    batch_s, single_s = [], []
    for j in range(args.batches):
        items = batch(64, f"b{j}-")
        t = time.perf_counter()
        absorb(fleet.schedule_batch(items))
        batch_s.append(time.perf_counter() - t)
    for item in batch(args.singles, "s"):
        t = time.perf_counter()
        absorb([fleet.schedule_request(*item)])
        single_s.append(time.perf_counter() - t)
    print(json.dumps(dict(
        tree=args.tree, hosts=args.hosts, batch_decisions_per_s=64 * args.batches / sum(batch_s),
        single_p50_ms=float(np.percentile(single_s, 50)) * 1e3,
        single_p99_ms=float(np.percentile(single_s, 99)) * 1e3,
        fallbacks=fleet.fallbacks - f0, digest=digest.hexdigest(),
        card=torch.cuda.get_device_name(0))), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of (other, this, this, other)")
    ap.add_argument("--hosts", type=int, default=65_536)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--singles", type=int, default=128)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        turn(args)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    other = os.path.abspath(args.other)
    rows = []
    for side, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)) * args.rounds:
        cmd = [sys.executable, os.path.abspath(__file__), "--other", other, "--tree", tree,
               "--hosts", str(args.hosts), "--batches", str(args.batches),
               "--singles", str(args.singles)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"decision_ab.py: the turn on {tree} failed:\n{out.stderr[-4000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["turn"] = side
        print(json.dumps(row), flush=True)
        rows.append(row)

    def spread(side, key):
        vals = [r[key] for r in rows if r["turn"] == side]
        return dict(mean=sum(vals) / len(vals), min=min(vals), max=max(vals))

    print(json.dumps(dict(
        card=smi, turns_each=2 * args.rounds,
        same_decisions=len({r["digest"] for r in rows}) == 1,
        **{f"{side}_{key}": spread(side, key) for side in ("other", "this")
           for key in ("batch_decisions_per_s", "single_p50_ms", "single_p99_ms")})))


if __name__ == "__main__":
    main()
