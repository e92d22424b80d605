"""Networks of the port (counterparts of ``openpifpaf_tpu/models``)."""

from .factory import BASE_FACTORIES, CHECKPOINT_URLS, \
    PRETRAINED_UNAVAILABLE, Factory
from .shell import Shell
