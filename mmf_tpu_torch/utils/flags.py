"""Command-line parser of ``mmf_run``.

Port of ``mmf_tpu/utils/flags.py``: ``config_override``, ``local_rank``
and the remaining ``key=value`` dotlist overrides.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="mmf_tpu_torch runner")
    group = parser.add_argument_group("Core Arguments")
    group.add_argument("-co", "--config_override", type=str, default=None,
                       help="Override config from the command line directly")
    group.add_argument("--local_rank", type=int, default=None,
                       help="Local rank of the node (accepted for "
                            "compatibility; the port runs one process)")
    group.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                       help="key=value dotlist config overrides")
    return parser


class Flags:
    def __init__(self):
        self.parser = build_parser()

    def get_parser(self) -> argparse.ArgumentParser:
        return self.parser


flags = Flags()
