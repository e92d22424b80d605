"""Decoders of the port (counterparts of ``openpifpaf_tpu/decoder``)."""

from .cifcaf import CifCaf, CifCafDense, cli, configure, factory
