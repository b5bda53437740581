from ctdirect_tpu_torch.transcription.docp import DOCP, transcribe
from ctdirect_tpu_torch.transcription.schemes import SCHEMES, get_scheme
from ctdirect_tpu_torch.transcription.strategies import Collocation, DirectShooting, discretize

__all__ = [
    "DOCP",
    "transcribe",
    "SCHEMES",
    "get_scheme",
    "Collocation",
    "DirectShooting",
    "discretize",
]
