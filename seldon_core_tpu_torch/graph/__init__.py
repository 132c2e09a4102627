from seldon_core_tpu_torch.graph.spec import (
    DeploymentSpec,
    Endpoint,
    EndpointType,
    Parameter,
    ParameterType,
    PredictiveUnit,
    PredictiveUnitImplementation,
    PredictiveUnitMethod,
    PredictiveUnitType,
    PredictorSpec,
    SeldonDeployment,
)
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.validation import ValidationError, validate_deployment

__all__ = [
    "DeploymentSpec",
    "Endpoint",
    "EndpointType",
    "Parameter",
    "ParameterType",
    "PredictiveUnit",
    "PredictiveUnitImplementation",
    "PredictiveUnitMethod",
    "PredictiveUnitType",
    "PredictorSpec",
    "SeldonDeployment",
    "ValidationError",
    "default_deployment",
    "validate_deployment",
]
