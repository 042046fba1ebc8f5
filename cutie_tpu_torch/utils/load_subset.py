"""Subset / empty-mask list loaders (the port's copy of cutie_tpu/utils/load_subset.py)."""
import json


def load_subset(path):
    with open(path) as f:
        return set(f.read().splitlines())


def load_empty_masks(path):
    with open(path) as f:
        return json.load(f)
