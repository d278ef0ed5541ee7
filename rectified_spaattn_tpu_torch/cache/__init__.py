from .teacache import (TeaCache, TeaCacheState, COEFFICIENTS, rel_l1_signal,
                       residual_value, schedule_from_trace)

__all__ = ["TeaCache", "TeaCacheState", "COEFFICIENTS", "rel_l1_signal",
           "residual_value", "schedule_from_trace"]
