"""EPOCH input-deck front end (the port's copy of ``epoch_tpu.deck``)."""
from .deck import DeckConfig, load_deck

__all__ = ["DeckConfig", "load_deck"]
