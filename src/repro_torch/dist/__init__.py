"""Distribution layer of the port (port of repro/dist): the compressed-mean
collectives on the local route and over ``torch.distributed`` meshes
(``collectives``), and the placement rules and chunk-ownership plans
(``sharding``)."""
