from ctdirect_tpu_torch.model.ocp import OCP, PreOCP, TimeSpec
from ctdirect_tpu_torch.model.define import define
from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.solution import Solution

__all__ = ["OCP", "PreOCP", "TimeSpec", "define", "InitialGuess", "Solution"]
