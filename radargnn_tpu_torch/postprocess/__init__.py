"""Box algebra, inference, postprocessing and evaluation."""

from radargnn_tpu_torch.postprocess.extraction import (  # noqa: F401
    BoxArray, Postprocessor, PredictionExtractor, GroundTruthExtractor,
    BoxSuppressor, decode_boxes_to_corners,
)
from radargnn_tpu_torch.postprocess.inference import Predictor  # noqa: F401
from radargnn_tpu_torch.postprocess.mean_ap import (  # noqa: F401
    MeanAveragePrecision,
)
from radargnn_tpu_torch.postprocess.segmentation_metrics import (  # noqa: F401
    ObjectDetectionMetrics, SegmentationMetrics,
)
from radargnn_tpu_torch.postprocess.evaluation import (  # noqa: F401
    Evaluator, RadarscenesEvaluator, evaluation_selector,
    get_new_evaluation_folder_path,
)
