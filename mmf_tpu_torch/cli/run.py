"""mmf_run: the training and inference command line.

Port of ``mmf_tpu/cli/run.py``, with the same invocation:

    python -m mmf_tpu_torch.cli.run config=<yaml> model=<name> \
        dataset=<name> [key=value ...]

``run(opts)`` is what ``python -m`` calls, and callers may call it in the
process (it returns the trainer). It trains on the card unless
``training.device=cpu`` is given. The port runs one process: there is no
distributed initialisation (a world size above 1 raises).
"""

from __future__ import annotations

import argparse
import logging
import typing

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.utils.flags import flags

logger = logging.getLogger("mmf_tpu_torch")


def main(configuration, predict: bool = False):
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.trainers.mmf_trainer import build_trainer
    from mmf_tpu_torch.utils.distributed import is_main, suppress_output
    from mmf_tpu_torch.utils.env import (
        set_seed,
        setup_imports,
        setup_run_folder,
    )
    from mmf_tpu_torch.utils.logger import setup_logger

    setup_imports()
    config = configuration.get_config()
    with omega.open_dict(config):
        config["training"]["seed"] = set_seed(config["training"]["seed"])
    registry.register("seed", config["training"]["seed"])
    registry.register("config", config)

    _, log_dir, _ = setup_run_folder(config)
    setup_logger(output=log_dir, color=config["training"]["colored_logs"],
                 disable=config["training"]["should_not_log"])
    suppress_output(is_main())
    configuration.pretty_print()

    trainer = build_trainer(config)
    trainer.load()
    try:
        if predict:
            trainer.inference()
        else:
            trainer.train()
    finally:
        trainer.teardown()
    return trainer


def run(opts: typing.Optional[typing.List[str]] = None,
        predict: bool = False):
    from mmf_tpu_torch.config.configuration import Configuration
    from mmf_tpu_torch.utils.distributed import infer_init_method
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    if opts is None:
        args = flags.get_parser().parse_args()
    else:
        args = argparse.Namespace(config_override=None, local_rank=None,
                                  opts=opts)
    configuration = Configuration(args)
    config = configuration.get_config()
    infer_init_method(config)
    if (config["distributed"].get("init_method", None) is not None
            and (config["distributed"].get("world_size", 1) or 1) > 1):
        raise NotImplementedError(
            "mmf_run in the port runs one process; distributed training "
            "(DDP) is not ported yet"
        )
    return main(configuration, predict=predict)


if __name__ == "__main__":
    run()
