"""Named source regions of the train step, for ``torch.profiler``.

``region(name)`` is ``torch.profiler.record_function(name)`` while a
profiler runs and a no-op context otherwise, so a step outside a profile
pays one flag test a region, and a CUDA graph's capture records no device
work for it.  A profile of an eager step then attributes each kernel to the
region that launched it (the backward pass's kernels to the forward region
whose operation they differentiate, through autograd's sequence numbers):
``chip_smoke.py`` prints kernels and device time a step by region.  A
range inside another takes its kernels (``natural_gradient_quantities``,
the bound's natural-gradient chain, inside ``gp_bound``).
"""

from __future__ import annotations

import contextlib

import torch

# the regions of the train step, in the order the step runs them
REGIONS = ("normalization", "encoder", "decoder", "heads_likelihoods", "nll",
           "gp_bound", "natural_gradient_quantities", "backward", "adam",
           "natural_gradient", "recon_metric")


def region(name: str):
    """A profiler range named ``name`` (one of ``REGIONS``) while a profiler
    runs, else a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
