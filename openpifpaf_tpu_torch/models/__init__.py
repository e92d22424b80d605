"""Networks of the port (counterparts of ``openpifpaf_tpu/models``)."""

from .factory import BASE_FACTORIES, Factory
from .shell import Shell
