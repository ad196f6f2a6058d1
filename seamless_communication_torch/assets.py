"""Asset cards (counterpart of ``seamless_communication_tpu/assets.py``).

Cards are YAML files in ``seamless_communication_torch/cards/`` (the port's
own copies of the cards it loads: the SeamlessM4T v2-large, v1-large and
v1-medium models, their NLLB bases, the two unit vocoders, the
SeamlessStreaming models, SeamlessExpressive's UnitY and its 24 and 16
kHz PRETSSEL vocoders, the ETOX word lists of ``mintox`` and the mExpresso
and Expresso datasets), with ``base:``
inheritance; their fields name the checkpoint and tokenizer, the arch, the
language lists and the vocoder's ``lang_spkr_idx_map``. ``SEAMLESS_CARDS_DIR``
names a directory of extra cards, searched first. Gated assets resolve
through ``SEAMLESS_GATED_ASSETS``, a local directory laid out as the
reference's ``add_gated_assets`` expects (store.py:12-32).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

CARDS_DIR = Path(__file__).parent / "cards"
# card name -> file name inside the gated dir (the reference's layout);
# <card>.pt is accepted too
_GATED = {"seamless_expressivity": "m2m_expressive_unity.pt",
          "vocoder_pretssel": "pretssel_melhifigan_wm.pt",
          "vocoder_pretssel_16khz": "pretssel_melhifigan_wm-16khz.pt"}


def load_card(name: str, *, cards_dir: Optional[Path] = None) -> Dict[str, Any]:
    """A card by name, its ``base:`` resolved (the child's fields win). The
    card and each base are looked up in ``SEAMLESS_CARDS_DIR`` first, then in
    the packaged cards, so a user's card can inherit from a packaged one."""
    if cards_dir is None:
        user_dir = os.environ.get("SEAMLESS_CARDS_DIR")
        if user_dir and (Path(user_dir) / f"{name}.yaml").exists():
            cards_dir = Path(user_dir)
        else:
            cards_dir = CARDS_DIR
    path = Path(cards_dir) / f"{name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"no asset card {name!r} in {cards_dir}")
    with open(path) as f:
        card = yaml.safe_load(f)
    if "base" in card:
        merged = dict(load_card(card["base"]))
        merged.update({k: v for k, v in card.items() if k != "base"})
        card = merged
    gated_dir = os.environ.get("SEAMLESS_GATED_ASSETS")
    if name in _GATED and gated_dir:
        for fname in (_GATED[name], f"{name}.pt"):
            local = Path(gated_dir) / fname
            if local.exists():
                card["checkpoint"] = str(local)
                break
    return card


def list_cards() -> list:
    return sorted(p.stem for p in CARDS_DIR.glob("*.yaml"))


def resolve_asset(url_or_path: str, *, cache_dir: Optional[str] = None) -> str:
    """An asset reference as a local path: a path that exists as it is, else
    the file of the URL's name in the cache directory (``cache_dir``, else
    ``SEAMLESS_CACHE``, else ``~/.cache/seamless_tpu``, shared with the JAX
    package). Nothing is downloaded: a missing asset raises."""
    if os.path.exists(url_or_path):
        return url_or_path
    cache_dir = cache_dir or os.environ.get(
        "SEAMLESS_CACHE", os.path.expanduser("~/.cache/seamless_tpu"))
    local = os.path.join(cache_dir, url_or_path.rstrip("/").split("/")[-1])
    if os.path.exists(local):
        return local
    raise FileNotFoundError(f"asset {url_or_path!r} is not a local file and not "
                            f"cached at {local}")
