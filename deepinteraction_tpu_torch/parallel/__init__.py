"""Multi-process data parallelism of the port (``torch.distributed``): the
process group (``mesh.py``) and the per-rank input and result gathering
(``input.py``)."""
