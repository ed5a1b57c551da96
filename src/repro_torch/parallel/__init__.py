"""The parallel layer: the mesh context (:mod:`.ctx`), the sharding rules
(:mod:`.sharding`) and the compressed gradient all-reduce
(:mod:`.collectives`), over ``torch.distributed``."""
