"""Optimizers: AdamW and Adafactor (factored second moment), and the int8
gradient quantizers."""
from .adafactor import (AdafactorConfig, AdafactorState, adafactor_update,
                        init_adafactor)
from .adam import AdamConfig, AdamState, adam_update, global_norm, init_adam

__all__ = ["AdamConfig", "AdamState", "adam_update", "global_norm",
           "init_adam", "AdafactorConfig", "AdafactorState",
           "adafactor_update", "init_adafactor"]
