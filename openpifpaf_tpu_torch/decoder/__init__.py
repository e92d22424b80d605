"""Decoders of the port (counterparts of ``openpifpaf_tpu/decoder``)."""

from .cifcaf import CifCaf, cli, configure, factory
