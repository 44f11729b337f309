# ``chart`` (matplotlib) is imported where it is used, so the main path needs
# only JAX and NumPy.
from . import analyzer, audit, checkpoint, db, feed, portfolio, qvoice, trainstore  # noqa: F401
