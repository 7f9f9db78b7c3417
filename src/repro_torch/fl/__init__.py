from repro_torch.fl.linear_eval import linear_evaluation  # noqa: F401
from repro_torch.fl.trainer import (FLCarry, FLConfig,  # noqa: F401
                                    FLResult, fl_train)
