"""The project's base directory (the port's copy of ``fact_clip_tpu/home.py``):
the registry's data paths and the CLIs' log directories are relative to it."""

import os


def get_project_base() -> str:
    pkg_dir = os.path.dirname(os.path.realpath(__file__))
    return os.path.dirname(pkg_dir) + "/"
