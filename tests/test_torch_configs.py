"""The port's EfficientViT, dense-LM, MoE-LM, recurrent and
encoder-decoder (whisper) configurations equal the JAX package's, field
for field (the port's ArchConfig carries all of JAX's fields but
``block_pattern`` and the execution knobs)."""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

NAMES = ["efficientvit-b1-r224", "efficientvit-b2-r224",
         "efficientvit-b1-r256", "efficientvit-b1-r288", "qwen1.5-0.5b",
         "qwen3-14b", "granite-3-8b", "minitron-4b", "internvl2-2b",
         "llama4-scout-17b-a16e", "dbrx-132b", "rwkv6-3b",
         "recurrentgemma-9b", "whisper-large-v3"]


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax(name):
    ours, theirs = treg.ARCHS[name], jreg.ARCHS[name]
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("name", ["efficientvit-b1-r224",
                                  "efficientvit-b2-r224", "qwen1.5-0.5b",
                                  "qwen3-14b", "granite-3-8b",
                                  "minitron-4b", "internvl2-2b",
                                  "llama4-scout-17b-a16e", "dbrx-132b",
                                  "rwkv6-3b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_reduced_config_equals_jax(name):
    ours, theirs = treg.REDUCED[name], jreg.REDUCED[name]
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
