"""Discretizer strategies (PyTorch port of
`ctdirect_tpu.transcription.strategies`).

`discretize(ocp, strategy, device=...)` mirrors the JAX package's
`discretize(ocp, strategy)`; the default discretizer is `Collocation()` with
grid_size=250 and scheme=midpoint. DirectShooting is the sub-sampled-control
mode: `control_steps` controls per integration step on the midpoint scheme.
The strategy holds the transcription options; the device and dtype of the
DOCP are given when it is applied."""

from __future__ import annotations

import torch

from ctdirect_tpu_torch.model.ocp import OCP
from ctdirect_tpu_torch.transcription.docp import DOCP
from ctdirect_tpu_torch.transcription.schemes import SCHEMES
from ctdirect_tpu_torch.utils.options import OptionDef, OptionSet


def _valid_scheme(s):
    return s in SCHEMES


def _grid_size_def():
    return OptionDef(
        "grid_size", int, 250, description="number of time steps N", validate=lambda v: v >= 1
    )


class Collocation:
    """Collocation discretizer strategy."""

    options = OptionSet(
        [
            _grid_size_def(),
            OptionDef(
                "scheme",
                str,
                "midpoint",
                aliases=("disc_method",),
                description=f"discretization scheme, one of {SCHEMES}",
                validate=_valid_scheme,
            ),
            OptionDef(
                "time_grid",
                object,
                None,
                description="explicit (possibly non-uniform) time grid; overrides grid_size",
            ),
        ]
    )
    def __init__(self, mode: str = "strict", **kwargs):
        self.opts = self.options.build(kwargs, mode=mode)

    def __call__(self, ocp: OCP, *, device, dtype: torch.dtype = torch.float64) -> DOCP:
        return DOCP(
            ocp,
            grid_size=self.opts["grid_size"],
            scheme=self.opts["scheme"],
            time_grid=self.opts["time_grid"],
            control_steps=self.opts.get("control_steps", 1),
            device=device,
            dtype=dtype,
        )

    @classmethod
    def metadata(cls):
        return cls.options.metadata()


class DirectShooting(Collocation):
    """Direct-shooting strategy: >=1 controls per integration step (midpoint)."""

    options = OptionSet(
        [
            _grid_size_def(),
            OptionDef(
                "control_steps",
                int,
                1,
                description="controls per integration step",
                validate=lambda v: v >= 1,
            ),
            OptionDef(
                "scheme",
                str,
                "midpoint",
                aliases=("disc_method",),
                description="integration scheme (midpoint only for control_steps > 1)",
                validate=_valid_scheme,
            ),
            OptionDef("time_grid", object, None, description="explicit time grid"),
        ]
    )


def discretize(ocp: OCP, strategy=None, *, device, dtype: torch.dtype = torch.float64) -> DOCP:
    """Front door: discretize with a strategy (default Collocation()) into a
    DOCP on `device` in `dtype`."""
    if strategy is None:
        strategy = Collocation()
    return strategy(ocp, device=device, dtype=dtype)
