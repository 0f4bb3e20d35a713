from hulc_tpu_torch.evaluation.lh_eval import evaluate_policy, get_sequences  # noqa: F401
from hulc_tpu_torch.evaluation.policy import HulcPolicy  # noqa: F401
from hulc_tpu_torch.evaluation.tasks import ALL_TASKS, SceneObsTasks  # noqa: F401
