"""Environment validation (reference src/utils/environment.py).

A copy of ``omr_a2s_multimodal_transformer_tpu/utils/environment.py``:
loads a .env file when python-dotenv is present and fail-fast-validates
required secrets — but only those actually needed: WANDB_API_KEY is
required only when wandb logging is enabled, HF_TOKEN only for HF Hub
access.
"""

from __future__ import annotations

import os
from typing import Iterable


def load_dotenv_if_available() -> None:
    try:
        from dotenv import load_dotenv

        load_dotenv()
    except ImportError:
        pass


def require_env(names: Iterable[str]) -> None:
    missing = [n for n in names if not os.environ.get(n)]
    if missing:
        raise OSError(f"Required environment variables missing or empty: {', '.join(missing)}")


def init_environment(require: Iterable[str] = ()) -> None:
    load_dotenv_if_available()
    require_env(require)
