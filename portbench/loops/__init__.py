"""Load drivers, one module a loop kind (``loops/<kind>.py``, named by a
traffic file's ``loop.kind``)."""
