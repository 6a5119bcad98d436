"""Run one example of the PyTorch port on a named device.

  PYTHONPATH=src python -m examples_torch.run NAME [--device cuda|cpu]
      [script args...]

``--device`` names where the port runs (default: the card, through
``repro_torch.device.resolve``, which raises without one). It is named
for everything the script calls with ``repro_torch.device.named``, so the
copied scripts, which take no device, build the planner cache of
``core/baselines.py`` there; nothing falls back to the CPU. The script
then runs as ``__main__`` with the remaining arguments as its
``sys.argv``.
"""
from __future__ import annotations

import argparse
import runpy
import sys

EXAMPLES = ("quickstart", "serve_fleet", "serve_under_volatility",
            "train_lm", "elastic_rescale")


def main(argv=None):
    from repro_torch.device import named

    ap = argparse.ArgumentParser(
        prog="python -m examples_torch.run",
        epilog=f"examples: {', '.join(EXAMPLES)}")
    ap.add_argument("name", help=f"one of: {', '.join(EXAMPLES)}")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args, rest = ap.parse_known_args(argv)
    if args.name not in EXAMPLES:
        raise SystemExit(f"unknown example {args.name!r}; examples: "
                         f"{', '.join(EXAMPLES)}")
    module = f"examples_torch.{args.name}"
    with named(args.device):
        saved = sys.argv
        sys.argv = [module, *rest]
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        finally:
            sys.argv = saved


if __name__ == "__main__":
    main()
