"""Multi-process training: the ("data", "fsdp") rank layout of
`mesh.py` over torch.distributed, and the collectives of
`collectives.py` it runs on."""
