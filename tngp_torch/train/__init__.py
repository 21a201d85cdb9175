from .cc_trainer import CCTrainer
from .checkpoint import latest_checkpoint, load_checkpoint, load_meta, save_checkpoint
from .dnerf_trainer import DNeRFTrainer
from .ema import ema_init, ema_update
from .metrics import LPIPSMeter, PSNRMeter, SSIMMeter
from .tensorf_trainer import TensoRFTrainer
from .trainer import Trainer, make_optimizer

__all__ = ["CCTrainer", "DNeRFTrainer", "TensoRFTrainer", "Trainer", "make_optimizer",
           "ema_init", "ema_update", "PSNRMeter", "SSIMMeter", "LPIPSMeter", "save_checkpoint",
           "latest_checkpoint", "load_meta", "load_checkpoint"]
