from repro_torch.distributed.chaos import (ChaosConfig, ChaosError,
                                           ChaosMonkey, ShardChaosConfig,
                                           ShardChaosMonkey, ShardKilledError,
                                           TrainChaosConfig, TrainChaosMonkey,
                                           TrainStepCrashError,
                                           TransientStepError, nan_grad_hook,
                                           nan_logits_hook)
from repro_torch.distributed.dispatcher import Dispatcher
from repro_torch.distributed.fault_tolerance import (HealthMonitor,
                                                     PreemptionHandler,
                                                     RestartManifest,
                                                     ShardState,
                                                     StragglerMonitor)

__all__ = ["PreemptionHandler", "StragglerMonitor", "RestartManifest",
           "HealthMonitor", "ShardState", "Dispatcher",
           "ChaosConfig", "ChaosError", "ChaosMonkey", "TransientStepError",
           "ShardChaosConfig", "ShardChaosMonkey", "ShardKilledError",
           "TrainChaosConfig", "TrainChaosMonkey", "TrainStepCrashError",
           "nan_grad_hook", "nan_logits_hook"]
