"""
The one traffic generator: a mix file's parameters and a seed give the
chunks of dedispersed series a survey node searches.

A chunk is ``dm_trials`` series of the configuration's ``nsamp``
samples: white noise drawn on the device by a seeded generator, with the
mix's ``pulsar`` (a train of von Mises pulses at each search range's
``pulsar_period``, the ``amplitude`` being the train's L2 norm, as
riptide's ``generate_signal`` makes it) added to the listed trials, which
so carry one pulsar a range, as a beam with several pulsars would; each
series then normalised to zero mean and unit variance, as a survey
searches whitened series. ``ring`` distinct chunks are made; the
window cycles through them.
"""
import math

import numpy as np
import torch

from .ranges import ranges

__all__ = ["slot_seed", "pulse_train", "make_chunk", "sample_trials"]


def slot_seed(seed, slot):
    """The generator seed of ring slot ``slot`` under run seed ``seed``
    (any whole number)."""
    return (int(seed) * 1_000_003 + int(slot)) % (1 << 63)


def pulse_train(nsamp, period, phi0, ducy, amplitude, device):
    """Noiseless von Mises pulse train of ``nsamp`` samples and
    ``period`` samples, FWHM ``ducy`` periods, L2 norm ``amplitude``
    (float64)."""
    kappa = math.log(2.0) / (2.0 * math.sin(math.pi * ducy / 2.0) ** 2)
    phase = (torch.arange(nsamp, dtype=torch.float64, device=device)
             / period - phi0) * (2.0 * math.pi)
    sig = torch.exp(kappa * (torch.cos(phase) - 1.0))
    return sig * (amplitude / torch.sqrt((sig * sig).sum()))


def make_chunk(cfg, mix, seed, slot, device):
    """Ring slot ``slot``'s (dm_trials, nsamp) float32 chunk, made on
    ``device`` from ``seed``."""
    D, N = int(mix["dm_trials"]), int(cfg["nsamp"])
    gen = torch.Generator(device=device)
    gen.manual_seed(slot_seed(seed, slot))
    x = torch.randn((D, N), generator=gen, dtype=torch.float32,
                    device=device)
    psr = mix["pulsar"]
    for _, rcfg in ranges(cfg):
        train = pulse_train(N, rcfg["pulsar_period"] / cfg["tsamp"],
                            psr["phi0"], psr["ducy"], psr["amplitude"],
                            device).float()
        for t in psr["trials"]:
            x[t] += train
    x -= x.mean(dim=1, keepdim=True)
    x /= x.std(dim=1, keepdim=True, correction=0)
    return x


def sample_trials(D, k, seed, slot):
    """The ``k`` trials of ring slot ``slot`` that the comparison reads,
    drawn from ``seed``: always the first (it carries the pulsar) and
    the last, the rest at random."""
    rng = np.random.default_rng([int(seed) % (1 << 63), int(slot)])
    rest = rng.choice(np.arange(1, D - 1), size=max(0, min(k, D) - 2),
                      replace=False)
    return sorted({0, D - 1, *(int(i) for i in rest)})
