"""Model distribution: a local cache of hub artifacts, downloaded on a miss.

Artifacts resolve from `https://huggingface.co/goooofy/{model}/resolve/main/{relpath}`
and are cached under `~/.cache/zerovox` (`CACHED_PATH_ZEROVOX` overrides
it), as in the JAX package's `hub.py`. An artifact already in the cache is
read without touching the network; in an offline environment a miss raises
a RuntimeError that says where to put the file.
"""

from __future__ import annotations

import os
import urllib.request
from pathlib import Path

DEFAULT_MELDEC_MODEL_NAME = "zerovox-hifigan-vctk-v2-en-1"
DEFAULT_TTS_MODEL_NAME_EN = "tts_en_zerovox2_medium_2_styledec"
DEFAULT_TTS_MODEL_NAME_DE = "tts_de_zerovox2_medium_3_styledec"


def cache_path() -> Path:
    return Path(os.getenv("CACHED_PATH_ZEROVOX", Path.home() / ".cache" / "zerovox"))


def get_default_model(lang: str) -> str:
    if lang == "de":
        return os.getenv("ZEROVOX_TTS_MODEL_DE", DEFAULT_TTS_MODEL_NAME_DE)
    return os.getenv("ZEROVOX_TTS_MODEL_EN", DEFAULT_TTS_MODEL_NAME_EN)


def download_model_file(model: str, relpath: str) -> Path:
    """Resolve (and download if needed) one artifact of a hub model."""
    target_dir = cache_path() / "model_repo" / model
    target_path = target_dir / relpath

    if target_path.exists():
        return target_path

    os.makedirs(target_dir, exist_ok=True)
    url = f"https://huggingface.co/goooofy/{model}/resolve/main/{relpath}?download=true"
    try:
        tmp = str(target_path) + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, target_path)
    except Exception as e:
        raise RuntimeError(
            f"could not download {url} and it is not cached at {target_path}; "
            f"pre-populate the cache (CACHED_PATH_ZEROVOX) in offline environments"
        ) from e
    return target_path
