from ctdirect_tpu_torch.utils.options import OptionDef, OptionError, OptionSet

__all__ = ["OptionDef", "OptionSet", "OptionError"]
