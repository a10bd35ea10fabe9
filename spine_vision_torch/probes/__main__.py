"""Print the measurement probes' tables.

    python -m spine_vision_torch.probes [copy|gelu|mlp|all] [--batch 32] [--device cuda]

Runs on the card by default (and raises without one); ``--device cpu`` runs
the plain versions at a small ``--batch`` and measures no time.
"""

from __future__ import annotations

import argparse

from spine_vision_torch.probes import PROBES, run


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probe", nargs="?", default="all", choices=PROBES + ("all",))
    parser.add_argument("--batch", type=int, default=32,
                        help="images of 512^2 the shapes stand for (the scripts' 32)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.probe, device=args.device, batch=args.batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
