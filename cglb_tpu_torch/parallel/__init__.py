"""Data parallelism over ``torch.distributed``: the rank mesh and its
collectives (``mesh``), the column-sharded streaming operator
(``streaming``) and the sharded CGLB loss and training step (``sharded``)."""
