"""Environment setup: seeding, auto-registration imports, user plugins,
the run folder.

Port of ``mmf_tpu/utils/env.py``: ``set_seed`` seeds Python's, numpy's
and torch's generators; ``setup_imports`` imports every module under the
port's ``models/``, ``modules/``, ``common/``, ``datasets/`` and
``trainers/`` so their ``@registry.register_*`` decorators run;
``import_user_module`` imports a user plugin directory (``env.user_dir``)
that extends the registry from outside the package;
``setup_run_folder`` makes the save and log folders. JAX's
``setup_compilation_cache`` is XLA's and has no counterpart.
"""

from __future__ import annotations

import glob
import importlib
import logging
import os
import random
import sys
from datetime import datetime

logger = logging.getLogger(__name__)


def set_seed(seed):
    """Seed Python's, numpy's and torch's generators; -1 draws a seed
    (reference env.py:16). Returns the seed in effect."""
    if seed:
        if seed == -1:
            seed = random.randint(1, 1000000)
        random.seed(seed)
        import numpy as np
        import torch

        np.random.seed(seed % (2 ** 32))
        torch.manual_seed(seed)
    return seed


def setup_imports():
    from mmf_tpu_torch.common.registry import registry

    if registry.get("imports_setup", no_warning=True):
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for sub in ("models", "modules", "common", "datasets", "trainers"):
        pattern = os.path.join(root, sub, "**", "*.py")
        for f in sorted(glob.glob(pattern, recursive=True)):
            if f.endswith("__init__.py"):
                continue
            rel = os.path.relpath(f, root)[: -len(".py")]
            importlib.import_module(
                "mmf_tpu_torch." + rel.replace(os.sep, ".")
            )
    registry.register("imports_setup", True)


def import_user_module(user_dir: str):
    """Import a user plugin folder so its registry registrations run
    (reference env.py:32-97). Relative paths resolve against the working
    directory, then the repository root. The import is cached per
    resolved path: a module of the same name from another folder is
    evicted (with its submodules) and this folder's is imported."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import get_repo_root

    if not user_dir:
        return
    user_dir = os.path.expanduser(user_dir)
    if not os.path.isabs(user_dir) and not os.path.exists(user_dir):
        candidate = os.path.join(get_repo_root(), user_dir)
        if os.path.exists(candidate):
            user_dir = candidate
    user_dir = os.path.abspath(user_dir)
    imported = registry.get("__mmf_user_dir_imported__", no_warning=True)
    if not isinstance(imported, set):
        imported = set()
    if user_dir in imported:
        logger.info(f"User dir {user_dir} already imported. Skipping.")
        return
    module_parent, module_name = os.path.split(user_dir)

    existing = sys.modules.get(module_name)
    if existing is not None:
        paths = list(getattr(existing, "__path__", []) or [])
        existing_dir = (os.path.realpath(paths[-1]) if paths else
                        os.path.dirname(os.path.realpath(
                            getattr(existing, "__file__", None) or "")))
        if existing_dir != os.path.realpath(user_dir):
            for k in [k for k in sys.modules
                      if k == module_name or k.startswith(module_name + ".")]:
                del sys.modules[k]
            existing = None
    if existing is None:
        sys.path.insert(0, module_parent)
        try:
            importlib.import_module(module_name)
        finally:
            sys.path.pop(0)

    logger.info(f"Importing from {user_dir}")
    imported.add(user_dir)
    registry.register("__mmf_user_dir_imported__", imported)
    registry.register("user_dir", user_dir)


def setup_run_folder(config):
    """Make ``env.save_dir`` and the log folder (``env.log_dir``, else
    ``<save_dir>/logs``); returns (save_dir, log_dir, report_dir)."""
    save_dir = config["env"]["save_dir"]
    log_dir = config["env"]["log_dir"] or os.path.join(save_dir, "logs")
    report_dir = config["env"]["report_dir"] or os.path.join(save_dir,
                                                             "reports")
    os.makedirs(save_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    return save_dir, log_dir, report_dir


def get_run_timestamp() -> str:
    return datetime.now().strftime("%Y_%m_%dT%H_%M_%S")
