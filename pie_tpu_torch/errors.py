"""Errors shared across the package's layers.

``InferenceError`` is a refused request: the model layer raises it for
inputs it cannot serve (an image placeholder count that does not match
the images), the engines for everything else, and the server answers it
with a 400. It lives here, below both, so a model module never imports
the engine above it; ``engine.engine`` re-exports it.
"""


class InferenceError(Exception):
    """Engine-level error surfaced to API handlers."""
