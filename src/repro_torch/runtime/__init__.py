"""Fault-tolerant training runtime (`trainer`)."""
from .trainer import StragglerAbort, Trainer, TrainerConfig  # noqa: F401
