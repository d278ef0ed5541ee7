from .teacache import (TeaCache, TeaCacheState, COEFFICIENTS, rel_l1_signal,
                       residual_value)

__all__ = ["TeaCache", "TeaCacheState", "COEFFICIENTS", "rel_l1_signal",
           "residual_value"]
