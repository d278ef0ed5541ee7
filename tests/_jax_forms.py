"""The JAX package's forms of what the port builds as the published model
has it, for the tests that hold the port to the JAX package: Wan2.1's
UniPC coefficients."""

import math

from rectified_spaattn_tpu_torch.pipelines import UniPCScheduler
from rectified_spaattn_tpu_torch.pipelines import wan as wan_pipelines


class JaxUniPC(UniPCScheduler):
    """UniPC as the JAX package steps it: B(h) = h, and the order-2
    predictor's rho solved from its 1 x 1 system, where the port takes
    the published bh2 form (B(h) = e^h - 1, rho 0.5)."""

    @staticmethod
    def _coeffs(hh):
        h_phi_1 = math.expm1(hh)
        h_phi_2 = h_phi_1 / hh - 1.0
        h_phi_3 = h_phi_2 / hh - 0.5
        b1 = h_phi_2 / hh
        return h_phi_1, hh, b1, b1, h_phi_3 * 2.0 / hh


def jax_unipc(monkeypatch=None):
    """Wan pipelines built from here on step with the JAX package's UniPC
    (for the test, with ``monkeypatch``; else for the process)."""
    if monkeypatch is None:
        wan_pipelines.UniPCScheduler = JaxUniPC
    else:
        monkeypatch.setattr(wan_pipelines, "UniPCScheduler", JaxUniPC)
