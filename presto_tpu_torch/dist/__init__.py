"""The stage-DAG distributed path (port of presto_tpu/dist): exchange
insertion and fragmentation, plan and page serde, the spooled-exchange
data plane, the stage scheduler and the DCN coordinator."""
