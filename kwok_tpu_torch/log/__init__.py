"""Logging setup for the kwok entry point (the pkg/log equivalent, cut to
what the CLI uses): a human TTY handler with a colored level
(pkg/log/logger_ctl.go:78-139) and the ``-v`` verbosity flag
(pkg/log/flags.go:26), on stdlib logging.

    14:02:11 INFO  engine started on cuda (managing all nodes)
"""

from kwok_tpu_torch.log.logger import add_flags, setup

__all__ = ["add_flags", "setup"]
