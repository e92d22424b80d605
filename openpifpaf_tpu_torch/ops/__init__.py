"""Decode ops of the port (counterparts of ``openpifpaf_tpu/ops``)."""
