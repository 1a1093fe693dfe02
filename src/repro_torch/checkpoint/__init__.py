from repro_torch.checkpoint.chain_io import (load_chain_state,  # noqa: F401
                                             save_chain_state)
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, committed_steps, latest_step, load_checkpoint,
    save_checkpoint)
