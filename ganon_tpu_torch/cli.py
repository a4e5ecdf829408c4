"""CLI entry: ``python -m ganon_tpu_torch.cli classify|build-custom ...``.

Takes the same flags as ``ganon_tpu.cli`` (one shared Config).
``classify`` and ``build-custom`` are ported and run on the card
(``main(..., device="cpu")`` runs the plain versions); the other
subcommands raise NotImplementedError naming the ROADMAP item that will
port them.
"""

from __future__ import annotations

import sys

from ganon_tpu_torch.config import Config
from ganon_tpu_torch.util import print_log

# subcommand -> the ROADMAP queue 1 item that ports it
_NOT_PORTED = {
    "build": "'build and update with offline acquisition'",
    "update": "'build and update with offline acquisition'",
    "reassign": "'reassign (EM) and report without pandas'",
    "report": "'reassign (EM) and report without pandas'",
    "table": "'reassign (EM) and report without pandas'",
}


def main(which: str = None, cfg=None, device="cuda", **kwargs) -> bool:
    if cfg is None:
        cfg = Config(which, **kwargs)
    cfg.validate()
    if cfg.which == "classify":
        from ganon_tpu_torch.commands import classify

        return classify(cfg)
    if cfg.which == "build_custom":
        from ganon_tpu_torch.build import build_custom

        return build_custom(cfg, device=device)
    if cfg.which in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.which} is not ported yet (ROADMAP queue 1, "
            f"{_NOT_PORTED[cfg.which]})"
        )
    raise ValueError(f"unknown subcommand: {cfg.which}")


def main_cli() -> None:
    try:
        ok = main()
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print_log(f"ERROR: {e}")
        sys.exit(1)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main_cli()
