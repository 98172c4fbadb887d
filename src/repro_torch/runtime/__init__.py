"""Control plane: the macro-batch work queue (``elastic``), straggler
stealing (``stragglers``), the fault taxonomy (``faults``) and the worker
processes' framed-pipe RPC (``transport``)."""
