"""Direct-solver subpackage: the host C++ multifrontal engine (api) and the
device multifrontal engine (device_mf)."""

from .api import Factorization  # noqa: F401
from .device_mf import DeviceFactorization  # noqa: F401
