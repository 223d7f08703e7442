"""Multi-process training and serving: the ("data", "fsdp") and
("data", "tp") rank layouts of `mesh.py` over torch.distributed, and the
collectives of `collectives.py` they run on."""
