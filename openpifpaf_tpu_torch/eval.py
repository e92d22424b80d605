"""``python -m openpifpaf_tpu_torch.eval`` — alias of :mod:`.eval_cli`
(named like the reference's ``openpifpaf.eval``)."""

from .eval_cli import main

if __name__ == '__main__':
    main()
