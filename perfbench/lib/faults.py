"""Faults planted under a cell's timed path, for the tests and for
``readings.py --fault``: each must make the cell's check come out false.

The work modules take a ``model_factory`` hook, which the network's pass
the program's UAHN. The faults are the ones a cell can have: ``prior`` (a
step that returns what it was given: the network gives back its prior),
``half`` (half of the batch left out, the rest's mean in its place),
``altered`` (one answer moved by half a pixel).
There is no exchange between cards to leave out: every cell runs on one.
"""

import torch

FAULTS = ("prior", "half", "altered")


class Faulty(torch.nn.Module):
    """The program's UAHN with one fault where its answers are produced:
    ``prior`` (the step returns what it was given: the prior as the flow),
    ``half`` (half of the batch left out, its rows the mean of the rest),
    ``altered`` (one answer moved by half a pixel)."""

    def __init__(self, model, fault: str):
        super().__init__()
        self.inner, self.fault = model, fault
        self.dropout_rate = model.dropout_rate
        self.corners = model.corners

    def forward(self, img1, img2, prior_offset=None, use_prior=False, dropout_keys=None):
        if self.fault == "prior":
            b = img1.shape[0]
            return (prior_offset.reshape(b, 8).clone(),
                    torch.eye(8, device=img1.device).expand(b, 8, 8).clone())
        if self.fault == "half":
            b = max(1, img1.shape[0] // 2)
            keys = None if dropout_keys is None else dropout_keys[:b]
            f, c = self.inner(img1[:b], img2[:b], prior_offset[:b], use_prior, keys)
            rest = img1.shape[0] - b
            return (torch.cat([f, f.mean(0, keepdim=True).expand(rest, 8)]),
                    torch.cat([c, c.mean(0, keepdim=True).expand(rest, 8, 8)]))
        f, c = self.inner(img1, img2, prior_offset, use_prior, dropout_keys)
        f = f.clone()
        f[0, 0] += 0.5
        return f, c


def fault_hook(fault: str):
    """The ``model_factory`` that plants ``fault`` under the network."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return lambda m: Faulty(m, fault)
