"""Auto-registration imports and user plugins.

Port of ``mmf_tpu/utils/env.py::setup_imports`` and
``import_user_module``: ``setup_imports`` imports every module under the
port's ``models/``, ``modules/`` and ``common/`` so their
``@registry.register_*`` decorators run; ``import_user_module`` imports a
user plugin directory (``env.user_dir``) that extends the registry from
outside the package.
"""

from __future__ import annotations

import glob
import importlib
import logging
import os
import sys

logger = logging.getLogger(__name__)


def setup_imports():
    from mmf_tpu_torch.common.registry import registry

    if registry.get("imports_setup", no_warning=True):
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for sub in ("models", "modules", "common"):
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
