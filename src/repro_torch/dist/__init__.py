"""Distribution layer of the port (port of repro/dist): the compressed-mean
collectives on the local route and over ``torch.distributed`` meshes
(``collectives``), the placement rules and chunk-ownership plans
(``sharding``), and the GPipe schedule over a ``pipe`` axis
(``pipeline``)."""
