"""Game constants for the JAX City of Gold (El Dorado) engine.

Mirrors the reference constant set (reference: include/constants.h:1-78) but is
an independent, array-oriented definition: everything here is a plain Python
int / IntEnum consumed by jitted JAX code as static values.
"""
from __future__ import annotations

import enum


class Difficulty(enum.IntEnum):
    EASY = 0
    MEDIUM = 1
    HARD = 2


DEFAULT_DIFFICULTY = Difficulty.EASY

# cards (reference: include/constants.h:15-21)
CARDS_PER_TYPE = 3
MAX_CARD_COPIES = 4
MKT_BOARD_SLOTS = 6
HAND_SIZE = 4
CARD_RESOURCETYPES = 3
N_BUYABLETYPES = 18
N_CARDTYPES = N_BUYABLETYPES + 3


class CardType(enum.IntEnum):
    # Machete cards
    EXPLORER = 0
    SCOUT = 1
    TRAILBLAZER = 2
    PIONEER = 3
    GIANT_MACHETE = 4
    # Paddle cards
    SAILOR = 5
    CAPTAIN = 6
    # Gold cards
    TRAVELER = 7
    PHOTOGRAPHER = 8
    JOURNALIST = 9
    TREASURE_CHEST = 10
    MILLIONAIRE = 11
    # Multi-resource cards
    JACK_OF_ALL_TRADES = 12
    ADVENTURER = 13
    PROP_PLANE = 14
    # Special cards
    TRANSMITTER = 15
    CARTOGRAPHER = 16
    COMPASS = 17
    SCIENTIST = 18
    TRAVEL_LOG = 19
    NATIVE = 20


# map (reference: include/constants.h:56-71)
N_MAP_FEATURES = 7
GRIDSIZE = 48
DEFAULT_N_PIECES = 3


class Resource(enum.IntEnum):
    MACHETE = 0
    PADDLE = 1
    COIN = 2


class Requirement(enum.IntEnum):
    MACHETE = 0
    PADDLE = 1
    COIN = 2
    DISCARD = 3
    REMOVE = 4
    NULL = 5  # impassable (mountains, empty cells, start hexes)


N_RESOURCETYPES = 3
N_REQUIREMENTS = 5

# environment (reference: include/constants.h:74-78)
MAX_N_PLAYERS = 4
MAX_FAILURES = 5


class TurnPhase(enum.IntEnum):
    INACTIVE = 0
    MOVEMENT = 1
    BUYING = 2


N_PHASES = 3
MAX_STEPS = 100000


class Direction(enum.IntEnum):
    NONE = 0
    EAST = 1
    NORTHEAST = 2
    NORTHWEST = 3
    WEST = 4
    SOUTHWEST = 5
    SOUTHEAST = 6


# Axial-coordinate unit steps, index-aligned with Direction
# (reference: include/geometry.h:42-51). Stored as (dx, dy) integer pairs.
DIRECTIONS = (
    (0, 0),
    (1, 0),
    (0, 1),
    (-1, 1),
    (-1, 0),
    (0, -1),
    (1, -1),
)
N_DIRECTIONS = 7

# Action head sizes (reference: include/api.h:95-119)
PLAY_HEAD = N_CARDTYPES + 1          # 22; index 0 = null
PLAY_SPECIAL_HEAD = N_CARDTYPES + 1  # 22
REMOVE_HEAD = N_CARDTYPES + 1        # 22
MOVE_HEAD = N_DIRECTIONS             # 7
SHOP_HEAD = N_BUYABLETYPES + 1       # 19
