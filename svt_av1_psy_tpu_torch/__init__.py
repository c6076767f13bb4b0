"""svt-av1-psy-tpu-torch: the PyTorch + CUDA (Hopper) port of svt_av1_psy_tpu.

The encoder's device programs run as kernels written by hand for sm_90a
(`csrc/*.cu`, built with nvcc at first use and bound with ctypes); every
host tier (native C decide/walk/entropy coding, filters, bitstream, rate
control) is the reference package's own code, imported unchanged. The
package imports torch and never jax.

  Encoder(cfg, device="cuda")   ~ svt_av1_psy_tpu.api.Encoder on a torch device
  EncoderConfig                 ~ the reference's configuration, re-exported
"""

from svt_av1_psy_tpu.config import EncoderConfig, parse_parameter, verify_settings
from svt_av1_psy_tpu.errors import ErrorCode, SvtAv1Error

__all__ = ["EncoderConfig", "parse_parameter", "verify_settings",
           "SvtAv1Error", "ErrorCode", "Encoder"]


def __getattr__(name):
    # lazy: config-only users do not import torch's encoder stack
    if name == "Encoder":
        from .api import Encoder

        return Encoder
    raise AttributeError(name)
