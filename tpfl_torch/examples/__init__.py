"""Runnable examples of the port (``tpfl-torch experiment list``)."""
