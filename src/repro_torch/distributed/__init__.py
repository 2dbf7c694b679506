"""Tensor-parallel serving: the process group (``runtime``), the serve
sharding rules (``sharding``) and the collectives of the paged and dense
decode attention (``collectives``)."""
