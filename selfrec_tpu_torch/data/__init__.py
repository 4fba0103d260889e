from selfrec_tpu_torch.data.interaction import Interaction

__all__ = ["Interaction"]
