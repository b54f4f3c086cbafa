"""Zero-shot metadata: the OpenAI ImageNet prompt templates and the class-name tables (port
of ``multimodal_tpu/eval/metadata.py``), read by path from the JSON asset the two packages
share (``paths.ZERO_SHOT_METADATA_PATH``): ImageNet and its A / R / O variants, CIFAR-10/100,
Flowers-102, Stanford Cars and Food-101. Templates are ``'{}'`` patterns applied with
``str.format``."""

from __future__ import annotations

import functools
import json

from multimodal_tpu_torch.paths import ZERO_SHOT_METADATA_PATH


@functools.lru_cache()
def _load() -> dict:
    with open(ZERO_SHOT_METADATA_PATH) as f:
        return json.load(f)


def templates(name: str = "openai") -> list:
    key = {
        "openai": "OPENAI_IMAGENET_TEMPLATES",
        "simple": "SIMPLE_IMAGENET_TEMPLATES",
        "identity": "IDENTITY_TEMPLATE",
    }[name]
    return _load()[key]


def classnames(dataset: str) -> list:
    key = {
        "imagenet": "IMAGENET_CLASSNAMES",
        "imagenet-v2": "IMAGENET_CLASSNAMES",
        "imagenet-sketch": "IMAGENET_CLASSNAMES",
        "imagenet-a": "IMAGENET_A_CLASSNAMES",
        "imagenet-r": "IMAGENET_R_CLASSNAMES",
        "imagenet-o": "IMAGENET_O_CLASSNAMES",
        "cifar10": "CIFAR10_CLASSNAMES",
        "cifar100": "CIFAR100_CLASSNAMES",
        "flowers102": "FLOWERS102_CLASSNAMES",
        "stanford-cars": "STANFORD_CARS_CLASSNAMES",
        "food101": "FOOD_CLASSNAMES",
    }[dataset]
    return _load()[key]


def apply_templates(classname: str, template_list: list) -> list:
    return [t.format(classname) for t in template_list]
