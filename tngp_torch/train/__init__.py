from .dnerf_trainer import DNeRFTrainer
from .ema import ema_init, ema_update
from .metrics import PSNRMeter
from .trainer import Trainer, make_optimizer

__all__ = ["DNeRFTrainer", "Trainer", "make_optimizer", "ema_init", "ema_update", "PSNRMeter"]
