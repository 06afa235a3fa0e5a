"""``python -m dpsvm_tpu_torch.resilience --selfcheck [--device cpu]``.

``--selfcheck`` runs ``resilience.selfcheck`` with the kill-one-host drill
included (real host processes); ``--host-drill`` runs only that drill and
prints its facts as a final JSON line (``host_loss_recovery_s``). The JAX
gate's ``--straggler-drill`` needs the fleet observability views, which
are not ported (ROADMAP item 13c-ii).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.resilience")
    p.add_argument("--selfcheck", action="store_true",
                   help="preempt + supervised resume (bitwise), the "
                        "corrupt-slot fallback, the kill-one-shard drill "
                        "over gloo ranks and the kill-one-host drill")
    p.add_argument("--host-drill", action="store_true",
                   help="run only the kill-one-host drill (3 local hosts, "
                        "one SIGKILLed mid-run, the survivors reformed "
                        "from the newest intact checkpoint); prints its "
                        "facts as a final JSON line")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every run trains (default cuda); the "
                        "drills' ranks and hosts are gloo ranks that "
                        "share the card")
    args = p.parse_args(argv)
    if not (args.selfcheck or args.host_drill):
        p.print_help()
        return 2
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("error: CUDA is not available (pass --device cpu)",
                  file=sys.stderr)
            return 2
    if args.host_drill:
        from dpsvm_tpu_torch.resilience import hostgroup
        with tempfile.TemporaryDirectory() as td:
            facts = hostgroup.host_loss_drill(td, device=args.device)
        print("host-loss drill OK: "
              f"recovered in {facts['host_loss_recovery_s']:.2f}s, "
              f"{facts['hosts']} -> {facts['surviving_hosts']} hosts, "
              f"coef delta {facts['coef_delta']:g}"
              + (" (bitwise)" if facts.get("bitwise") else ""),
              file=sys.stderr)
        print(json.dumps(facts))
        return 0
    from dpsvm_tpu_torch.resilience import selfcheck
    problems = selfcheck(host_drill=True, device=args.device)
    if problems:
        print("resilience selfcheck FAILED:", file=sys.stderr)
        for pr in problems:
            print(f"  {pr}", file=sys.stderr)
        return 1
    print("resilience selfcheck OK (preempt + retry + rotation fallback + "
          "kill-shard degraded-mesh drill + kill-host reformation drill, "
          "bitwise resume)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
