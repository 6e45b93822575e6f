"""The port's management plane: the logger subset the learning layer calls."""
