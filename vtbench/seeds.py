"""Everything random in a run comes from ``--seed`` through here: derived
seeds by name, and weights made on the device in one draw."""

import hashlib

import numpy as np
import torch


def derive(seed, *tags):
    """A 63-bit seed from ``seed`` (any whole number) and ``tags``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for tag in tags:
        h = hashlib.sha256(str(tag).encode()).digest()
        words += list(np.frombuffer(h[:8], dtype=np.uint32))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def rng(seed, *tags):
    return np.random.default_rng(derive(seed, *tags))


def generator(device, seed, *tags):
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def make_weights(seed, specs, device):
    """{name: fp32 tensor} from ``specs`` {name: (shape, mean, std)}: one
    normal draw on ``device`` for all of them together, in sorted name
    order, each slice scaled to its std and shifted to its mean. The same
    seed gives the same weights on the same kind of device."""
    names = sorted(specs)
    sizes = [int(np.prod(specs[n][0])) for n in names]
    g = generator(device, seed, "weights")
    flat = torch.randn(sum(sizes), generator=g, device=device,
                       dtype=torch.float32)
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        shape, mean, std = specs[name]
        out[name] = (part * std + mean).view(shape)
    return out
