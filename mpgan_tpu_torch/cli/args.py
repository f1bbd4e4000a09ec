"""CLI argument parsing (``mpgan_tpu/cli/args.py``): the reference's whole flag
surface, generated from ``config.defaults()``. Every key becomes ``--key``
with hyphens; booleans get the paired ``--x`` / ``--no-x`` form
(setup_training.py:17-27), and ``sum``'s negation is also spelled ``--mean``
(setup_training.py:503). The same argv gives the same ``Args`` dict as the
JAX package."""

from __future__ import annotations

import argparse

from ..training.config import Args, ArgsError, defaults, process_args


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="mpgan_tpu_torch training")
    for key, default in defaults().items():
        flag = "--" + key.replace("_", "-")
        if isinstance(default, bool):
            group = parser.add_mutually_exclusive_group(required=False)
            group.add_argument(flag, dest=key, action="store_true")
            group.add_argument("--no-" + key.replace("_", "-"), dest=key, action="store_false")
            if key == "sum":
                group.add_argument("--mean", dest=key, action="store_false")
            parser.set_defaults(**{key: default})
        elif isinstance(default, list):
            elem_type = type(default[0]) if default else int
            parser.add_argument(flag, dest=key, type=elem_type, nargs="*", default=default)
        elif default is None:
            parser.add_argument(flag, dest=key, default=None)
        else:
            parser.add_argument(flag, dest=key, type=type(default), default=default)
    return parser


def parse_cli(argv: list[str] | None = None) -> Args:
    parser = build_parser()
    args = Args(vars(parser.parse_args(argv)))
    try:
        process_args(args)
    except ArgsError as e:
        # the reference logs and exits on these configs (setup_training.py:717-744)
        parser.error(f"{e} - exiting")
    return args
