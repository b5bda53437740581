from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state, shift_state

__all__ = ["MPCController", "broadcast_state", "shift_state"]
