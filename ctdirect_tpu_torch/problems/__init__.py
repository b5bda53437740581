"""Fixture OCP library with known reference objectives (PyTorch port of
`ctdirect_tpu.problems`; each entry returns (ocp, obj, name, init)). Every
fixture of the JAX package is ported: `problem_names()` is the same list in
both packages."""

from __future__ import annotations

from typing import NamedTuple, Optional

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import OCP


class Problem(NamedTuple):
    ocp: OCP
    obj: Optional[float]
    name: str
    init: Optional[InitialGuess] = None


_REGISTRY = {}


def register(fn):
    _REGISTRY[fn.__name__] = fn
    return fn


def get_problem(name: str) -> Problem:
    return _REGISTRY[name]()


def problem_names():
    return sorted(_REGISTRY)


from ctdirect_tpu_torch.problems import basic  # noqa: E402,F401
from ctdirect_tpu_torch.problems import goddard  # noqa: E402,F401
from ctdirect_tpu_torch.problems import advanced  # noqa: E402,F401
from ctdirect_tpu_torch.problems import misc  # noqa: E402,F401
from ctdirect_tpu_torch.problems import vehicles  # noqa: E402,F401
from ctdirect_tpu_torch.problems import mpc_fixtures  # noqa: E402,F401
