# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seldon_deployment.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x17seldon_deployment.proto\x12\nseldon.tpu\"\xb6\x01\n\x10SeldonDeployment\x12\x12\n\napiVersion\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12(\n\x08metadata\x18\x03 \x01(\x0b\x32\x16.seldon.tpu.ObjectMeta\x12(\n\x04spec\x18\x04 \x01(\x0b\x32\x1a.seldon.tpu.DeploymentSpec\x12,\n\x06status\x18\x05 \x01(\x0b\x32\x1c.seldon.tpu.DeploymentStatus\"\x9b\x02\n\nObjectMeta\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x32\n\x06labels\x18\x03 \x03(\x0b\x32\".seldon.tpu.ObjectMeta.LabelsEntry\x12<\n\x0b\x61nnotations\x18\x04 \x03(\x0b\x32\'.seldon.tpu.ObjectMeta.AnnotationsEntry\x12\x17\n\x0fresourceVersion\x18\x05 \x01(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xec\x01\n\x0e\x44\x65ploymentSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12-\n\npredictors\x18\x02 \x03(\x0b\x32\x19.seldon.tpu.PredictorSpec\x12\x11\n\toauth_key\x18\x03 \x01(\t\x12\x14\n\x0coauth_secret\x18\x04 \x01(\t\x12@\n\x0b\x61nnotations\x18\x05 \x03(\x0b\x32+.seldon.tpu.DeploymentSpec.AnnotationsEntry\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xa3\x02\n\rPredictorSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12)\n\x05graph\x18\x02 \x01(\x0b\x32\x1a.seldon.tpu.PredictiveUnit\x12\x30\n\rcomponentSpec\x18\x03 \x01(\x0b\x32\x19.seldon.tpu.ComponentSpec\x12\x10\n\x08replicas\x18\x04 \x01(\x05\x12?\n\x0b\x61nnotations\x18\x05 \x03(\x0b\x32*.seldon.tpu.PredictorSpec.AnnotationsEntry\x12 \n\x03tpu\x18\x06 \x01(\x0b\x32\x13.seldon.tpu.TpuSpec\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\">\n\rComponentSpec\x12-\n\ncontainers\x18\x01 \x03(\x0b\x32\x19.seldon.tpu.ContainerSpec\"\x9c\x01\n\rContainerSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05image\x18\x02 \x01(\t\x12/\n\x03\x65nv\x18\x03 \x03(\x0b\x32\".seldon.tpu.ContainerSpec.EnvEntry\x12\x11\n\tmodel_uri\x18\x04 \x01(\t\x1a*\n\x08\x45nvEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x99\x06\n\x0ePredictiveUnit\x12\x0c\n\x04name\x18\x01 \x01(\t\x12,\n\x08\x63hildren\x18\x02 \x03(\x0b\x32\x1a.seldon.tpu.PredictiveUnit\x12;\n\x04type\x18\x03 \x01(\x0e\x32-.seldon.tpu.PredictiveUnit.PredictiveUnitType\x12O\n\x0eimplementation\x18\x04 \x01(\x0e\x32\x37.seldon.tpu.PredictiveUnit.PredictiveUnitImplementation\x12@\n\x07methods\x18\x05 \x03(\x0e\x32/.seldon.tpu.PredictiveUnit.PredictiveUnitMethod\x12&\n\x08\x65ndpoint\x18\x06 \x01(\x0b\x32\x14.seldon.tpu.Endpoint\x12)\n\nparameters\x18\x07 \x03(\x0b\x32\x15.seldon.tpu.Parameter\"t\n\x12PredictiveUnitType\x12\x10\n\x0cUNKNOWN_TYPE\x10\x00\x12\n\n\x06ROUTER\x10\x01\x12\x0c\n\x08\x43OMBINER\x10\x02\x12\t\n\x05MODEL\x10\x03\x12\x0f\n\x0bTRANSFORMER\x10\x04\x12\x16\n\x12OUTPUT_TRANSFORMER\x10\x05\"\xc1\x01\n\x1cPredictiveUnitImplementation\x12\x1a\n\x16UNKNOWN_IMPLEMENTATION\x10\x00\x12\x10\n\x0cSIMPLE_MODEL\x10\x01\x12\x11\n\rSIMPLE_ROUTER\x10\x02\x12\x11\n\rRANDOM_ABTEST\x10\x03\x12\x14\n\x10\x41VERAGE_COMBINER\x10\x04\x12\x12\n\x0e\x45PSILON_GREEDY\x10\x05\x12\r\n\tJAX_MODEL\x10\x06\x12\x14\n\x10MEAN_TRANSFORMER\x10\x07\"n\n\x14PredictiveUnitMethod\x12\x13\n\x0fTRANSFORM_INPUT\x10\x00\x12\x14\n\x10TRANSFORM_OUTPUT\x10\x01\x12\t\n\x05ROUTE\x10\x02\x12\r\n\tAGGREGATE\x10\x03\x12\x11\n\rSEND_FEEDBACK\x10\x04\"\x8b\x01\n\x08\x45ndpoint\x12\x14\n\x0cservice_host\x18\x01 \x01(\t\x12\x14\n\x0cservice_port\x18\x02 \x01(\x05\x12/\n\x04type\x18\x03 \x01(\x0e\x32!.seldon.tpu.Endpoint.EndpointType\"\"\n\x0c\x45ndpointType\x12\x08\n\x04REST\x10\x00\x12\x08\n\x04GRPC\x10\x01\"\xa2\x01\n\tParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x31\n\x04type\x18\x03 \x01(\x0e\x32#.seldon.tpu.Parameter.ParameterType\"E\n\rParameterType\x12\x07\n\x03INT\x10\x00\x12\t\n\x05\x46LOAT\x10\x01\x12\n\n\x06\x44OUBLE\x10\x02\x12\n\n\x06STRING\x10\x03\x12\x08\n\x04\x42OOL\x10\x04\"\xeb\x01\n\x07TpuSpec\x12+\n\x04mesh\x18\x01 \x03(\x0b\x32\x1d.seldon.tpu.TpuSpec.MeshEntry\x12\x15\n\rbatch_buckets\x18\x02 \x03(\x05\x12\x11\n\tmax_batch\x18\x03 \x01(\x05\x12\x18\n\x10\x62\x61tch_timeout_ms\x18\x04 \x01(\x02\x12\r\n\x05\x64type\x18\x05 \x01(\t\x12\x14\n\x0c\x64onate_input\x18\x06 \x01(\x08\x12\x1d\n\x15\x62\x61tch_across_requests\x18\x07 \x01(\x08\x1a+\n\tMeshEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\"q\n\x0fPredictorStatus\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x10\n\x08replicas\x18\x04 \x01(\x05\x12\x19\n\x11replicasAvailable\x18\x05 \x01(\x05\"l\n\x10\x44\x65ploymentStatus\x12\r\n\x05state\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\x12\x34\n\x0fpredictorStatus\x18\x03 \x03(\x0b\x32\x1b.seldon.tpu.PredictorStatusb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seldon_deployment_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _OBJECTMETA_LABELSENTRY._options = None
  _OBJECTMETA_LABELSENTRY._serialized_options = b'8\001'
  _OBJECTMETA_ANNOTATIONSENTRY._options = None
  _OBJECTMETA_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _DEPLOYMENTSPEC_ANNOTATIONSENTRY._options = None
  _DEPLOYMENTSPEC_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _PREDICTORSPEC_ANNOTATIONSENTRY._options = None
  _PREDICTORSPEC_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERSPEC_ENVENTRY._options = None
  _CONTAINERSPEC_ENVENTRY._serialized_options = b'8\001'
  _TPUSPEC_MESHENTRY._options = None
  _TPUSPEC_MESHENTRY._serialized_options = b'8\001'
  _SELDONDEPLOYMENT._serialized_start=40
  _SELDONDEPLOYMENT._serialized_end=222
  _OBJECTMETA._serialized_start=225
  _OBJECTMETA._serialized_end=508
  _OBJECTMETA_LABELSENTRY._serialized_start=411
  _OBJECTMETA_LABELSENTRY._serialized_end=456
  _OBJECTMETA_ANNOTATIONSENTRY._serialized_start=458
  _OBJECTMETA_ANNOTATIONSENTRY._serialized_end=508
  _DEPLOYMENTSPEC._serialized_start=511
  _DEPLOYMENTSPEC._serialized_end=747
  _DEPLOYMENTSPEC_ANNOTATIONSENTRY._serialized_start=458
  _DEPLOYMENTSPEC_ANNOTATIONSENTRY._serialized_end=508
  _PREDICTORSPEC._serialized_start=750
  _PREDICTORSPEC._serialized_end=1041
  _PREDICTORSPEC_ANNOTATIONSENTRY._serialized_start=458
  _PREDICTORSPEC_ANNOTATIONSENTRY._serialized_end=508
  _COMPONENTSPEC._serialized_start=1043
  _COMPONENTSPEC._serialized_end=1105
  _CONTAINERSPEC._serialized_start=1108
  _CONTAINERSPEC._serialized_end=1264
  _CONTAINERSPEC_ENVENTRY._serialized_start=1222
  _CONTAINERSPEC_ENVENTRY._serialized_end=1264
  _PREDICTIVEUNIT._serialized_start=1267
  _PREDICTIVEUNIT._serialized_end=2060
  _PREDICTIVEUNIT_PREDICTIVEUNITTYPE._serialized_start=1636
  _PREDICTIVEUNIT_PREDICTIVEUNITTYPE._serialized_end=1752
  _PREDICTIVEUNIT_PREDICTIVEUNITIMPLEMENTATION._serialized_start=1755
  _PREDICTIVEUNIT_PREDICTIVEUNITIMPLEMENTATION._serialized_end=1948
  _PREDICTIVEUNIT_PREDICTIVEUNITMETHOD._serialized_start=1950
  _PREDICTIVEUNIT_PREDICTIVEUNITMETHOD._serialized_end=2060
  _ENDPOINT._serialized_start=2063
  _ENDPOINT._serialized_end=2202
  _ENDPOINT_ENDPOINTTYPE._serialized_start=2168
  _ENDPOINT_ENDPOINTTYPE._serialized_end=2202
  _PARAMETER._serialized_start=2205
  _PARAMETER._serialized_end=2367
  _PARAMETER_PARAMETERTYPE._serialized_start=2298
  _PARAMETER_PARAMETERTYPE._serialized_end=2367
  _TPUSPEC._serialized_start=2370
  _TPUSPEC._serialized_end=2605
  _TPUSPEC_MESHENTRY._serialized_start=2562
  _TPUSPEC_MESHENTRY._serialized_end=2605
  _PREDICTORSTATUS._serialized_start=2607
  _PREDICTORSTATUS._serialized_end=2720
  _DEPLOYMENTSTATUS._serialized_start=2722
  _DEPLOYMENTSTATUS._serialized_end=2830
# @@protoc_insertion_point(module_scope)
