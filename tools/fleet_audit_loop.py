"""Loop phase 10c's fleet scenarios on the card and name any duplicate.

Usage (on a machine with a CUDA card, from the repo root):

    python tools/fleet_audit_loop.py [--loops 50] [--out DIR]

Builds ``chip_smoke.py`` phase 10c's fleet once (three LM replicas at
full width, S = ``REST_SEQ``, behind ``cluster/chaos.py`` ``ServingSoak``)
and runs ``run_kill`` then ``run_drain`` ``--loops`` times, each loop
into a fresh span sink. After each loop it audits the sink as
``ServingSoak.audit()`` does; for every request id that reads ``ok`` on
two server spans it writes every span of that id (the server spans, the
router's ``fleet-retry`` events with the failed attempt's reason, and
the ``fleet-request`` ledger) to ``<out>/dup-<loop>.json`` (``--out``
defaults to a new temporary directory, printed first). The last line
printed is a JSON summary: loops run, loops with a duplicate, and for
each duplicate its scenario (the id's prefix) and the reasons of the
retries that preceded its second completion.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def duplicates(spans: list, gp) -> dict:
    """request id -> server spans that read ok, for the kill- and
    drain- ids answered ok more than once."""
    served: dict = {}
    for s in spans:
        if s.get("name") != gp.SERVING_REQUEST_SPAN:
            continue
        rid = str(s.get("trace_id", ""))
        if rid.startswith(("kill-", "drain-")) and \
                (s.get("attrs") or {}).get("outcome") == "ok":
            served.setdefault(rid, []).append(s)
    return {rid: v for rid, v in served.items() if len(v) > 1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--loops", type=int, default=50)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    args.out = args.out or tempfile.mkdtemp(prefix="fleet-audit-")
    print(f"fleet_audit_loop: duplicates go to {args.out}", flush=True)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("fleet_audit_loop: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as C
    from kubeflow_tpu_torch.cluster import chaos
    from kubeflow_tpu_torch.obs import goodput as gp
    from kubeflow_tpu_torch.obs.trace import load_spans
    from kubeflow_tpu_torch.serving import servable as TS

    os.makedirs(args.out, exist_ok=True)
    repo = TS.ModelRepository()
    bases = []
    for i in range(C.FLEET_REPLICAS):
        b = repo.load(f"fleet{i}", "transformer_lm", attention="flash",
                      max_seq_len=C.REST_SEQ, device=C.DEVICE)
        b.max_batch = C.MAX_BATCH
        b.warmup([1, 2, 4, 8])
        bases.append(b)
    replicas = [C.token_servable(TS, "lm", b) for b in bases]
    rng = np.random.default_rng(12)
    xs = [rng.integers(0, C.SERVE_VOCAB, (1, C.REST_SEQ)).astype(np.int32)
          for _ in range(8)]
    bodies = [json.dumps({"instances": x.tolist(),
                          "dtype": "int32"}).encode() for x in xs]
    found = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kftpu-fleet-loop-") as tmp:
        for loop in range(args.loops):
            sink = os.path.join(tmp, f"spans-{loop}.jsonl")
            soak = chaos.ServingSoak(
                span_path=sink, replicas=C.FLEET_REPLICAS,
                servables=replicas, bodies=bodies,
                seconds=C.FLEET_SECONDS, threads=C.FLEET_THREADS)
            kill = soak.run_kill()
            drain = soak.run_drain()
            audit = soak.audit()
            spans = load_spans(sink)
            dups = duplicates(spans, gp)
            line = {"loop": loop,
                    "kill": [kill["ok"], kill["requests"]],
                    "drain": [drain["ok"], drain["requests"]],
                    "duplicate_side_effects":
                        audit["duplicate_side_effects"],
                    "retry_badput_s": audit["retry_badput_s"]}
            print(json.dumps(line), flush=True)
            for rid, ok_spans in dups.items():
                mine = [s for s in spans
                        if str(s.get("trace_id", "")) == rid]
                reasons = [(s.get("attrs") or {}).get("reason")
                           for s in mine if s.get("name") == "fleet-retry"]
                found.append({"loop": loop, "rid": rid,
                              "scenario": rid.split("-")[0],
                              "ok_spans": len(ok_spans),
                              "retry_reasons": reasons})
                with open(os.path.join(args.out, f"dup-{loop}.json"),
                          "a") as f:
                    f.write(json.dumps({"rid": rid, "spans": mine}) + "\n")
    print(json.dumps({"loops": args.loops,
                      "loops_with_duplicate": len({d["loop"]
                                                   for d in found}),
                      "duplicates": found,
                      "seconds": round(time.perf_counter() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
