"""Data-parallel training over ranks, one process per device (``mesh.py``),
and the rank programs that check it (``ranks.py``)."""
