from repro_torch.distributed.chaos import (ChaosError, TrainChaosConfig,
                                           TrainChaosMonkey,
                                           TrainStepCrashError, nan_grad_hook)
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     RestartManifest,
                                                     StragglerMonitor)

__all__ = ["PreemptionHandler", "StragglerMonitor", "RestartManifest",
           "ChaosError", "TrainChaosConfig", "TrainChaosMonkey",
           "TrainStepCrashError", "nan_grad_hook"]
