"""Direct-solver subpackage: the host C++ multifrontal engine (api)."""

from .api import Factorization  # noqa: F401
