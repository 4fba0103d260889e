"""Scale-out layer of the port (counterpart of ``selfrec_tpu/parallel``):
the (data, model) mesh over ``torch.distributed`` (:mod:`.mesh`), process
start-up (:mod:`.distributed`), the sharded dense block on kernel K1
(:mod:`.dense_shard`), the halo exchange on kernel K2 (:mod:`.halo`) and
the sharded top-k (:mod:`.topk`)."""
