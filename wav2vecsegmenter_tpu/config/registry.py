"""`_target_` instantiation registry.

The reference uses ``hydra.utils.instantiate`` to build models, dataloader
generators, vocabularies and losses straight from config
(/root/reference/train.py:257-287, conf/task/shas.yaml:4).  This registry
preserves that dependency-injection surface: reference target strings
(``lib.models.SHAS``, ``torch.nn.BCEWithLogitsLoss``, ...) are remapped to
this framework's JAX equivalents, and new-style
``wav2vecsegmenter_tpu.*`` targets resolve by import path.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

from .config import to_plain

# reference-target -> "module:attr" within this package
_ALIASES: dict[str, str] = {
    # models (lib/models.py)
    "lib.models.SHAS": "wav2vecsegmenter_tpu.models.shas:SHAS",
    "lib.models.SHASWithSSL": "wav2vecsegmenter_tpu.models.shas:SHASWithSSL",
    # the reference's shas_ctc config targets a class that does not exist in
    # the reference (dead config); map it to the CTC-capable SSL backbone
    "lib.models.SHASWithCTC": "wav2vecsegmenter_tpu.models.shas:SHASWithSSL",
    "lib.models.AutoRegSegmenter": "wav2vecsegmenter_tpu.models.shas:AutoRegSegmenter",
    # dataloader generators (lib/dataset.py)
    "lib.dataset.RandomDataloaderGenerator": (
        "wav2vecsegmenter_tpu.data.loader:RandomDataloaderGenerator"
    ),
    "lib.dataset.FixedDataloaderGenerator": (
        "wav2vecsegmenter_tpu.data.loader:FixedDataloaderGenerator"
    ),
    # vocabularies (lib/datautils.py)
    "lib.datautils.BaseVocabulary": "wav2vecsegmenter_tpu.data.vocab:BaseVocabulary",
    "lib.datautils.UppercasedCharVocabulary": (
        "wav2vecsegmenter_tpu.data.vocab:UppercasedCharVocabulary"
    ),
    # losses (torch.nn / lib/loss.py) -> functional loss specs
    "torch.nn.BCEWithLogitsLoss": "wav2vecsegmenter_tpu.train.loss:BCEWithLogitsLoss",
    "torch.nn.CrossEntropyLoss": "wav2vecsegmenter_tpu.train.loss:CrossEntropyLoss",
    "torch.nn.CTCLoss": "wav2vecsegmenter_tpu.train.loss:CTCLoss",
    "lib.loss.FocalLoss": "wav2vecsegmenter_tpu.train.loss:FocalLoss",
}


def register(target: str, path: str) -> None:
    _ALIASES[target] = path


def resolve_target(target: str) -> Callable:
    if target in _ALIASES:
        spec = _ALIASES[target]
        module_name, attr = spec.split(":")
    elif target.startswith("wav2vecsegmenter_tpu."):
        module_name, attr = target.rsplit(".", 1)
    else:
        raise KeyError(
            f"Unknown _target_ '{target}'. Register it with "
            "wav2vecsegmenter_tpu.config.registry.register()."
        )
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(node: Any, **kwargs: Any) -> Any:
    """Build the object described by a config node with a ``_target_`` key.

    Extra kwargs override/extend the config values (matching
    hydra.utils.instantiate(config, **kwargs)).  Nested dicts with their own
    ``_target_`` are instantiated recursively.
    """
    if node is None:
        return None
    if not isinstance(node, dict):
        raise TypeError(f"instantiate() expects a config dict, got {type(node)}")
    node = dict(node)
    target = node.pop("_target_", None)
    if target is None:
        raise ValueError("Config node has no _target_ key")

    def build_arg(v: Any) -> Any:
        if isinstance(v, dict) and "_target_" in v:
            return instantiate(v)
        if isinstance(v, (dict, list)):
            return to_plain(v)
        return v

    call_kwargs = {k: build_arg(v) for k, v in node.items()}
    call_kwargs.update(kwargs)
    fn = resolve_target(target)
    return fn(**call_kwargs)
