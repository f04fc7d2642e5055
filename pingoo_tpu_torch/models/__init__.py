"""Learned components (the bot-score head)."""

from . import botscore

__all__ = ["botscore"]
