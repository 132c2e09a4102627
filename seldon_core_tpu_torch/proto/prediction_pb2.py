# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: prediction.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10prediction.proto\x12\nseldon.tpu\x1a\x1cgoogle/protobuf/struct.proto\"\xb0\x01\n\rSeldonMessage\x12\"\n\x06status\x18\x01 \x01(\x0b\x32\x12.seldon.tpu.Status\x12\x1e\n\x04meta\x18\x02 \x01(\x0b\x32\x10.seldon.tpu.Meta\x12\'\n\x04\x64\x61ta\x18\x03 \x01(\x0b\x32\x17.seldon.tpu.DefaultDataH\x00\x12\x11\n\x07\x62inData\x18\x04 \x01(\x0cH\x00\x12\x11\n\x07strData\x18\x05 \x01(\tH\x00\x42\x0c\n\ndata_oneof\"\x7f\n\x0b\x44\x65\x66\x61ultData\x12\r\n\x05names\x18\x01 \x03(\t\x12$\n\x06tensor\x18\x02 \x01(\x0b\x32\x12.seldon.tpu.TensorH\x00\x12-\n\x07ndarray\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.ListValueH\x00\x42\x0c\n\ndata_oneof\"/\n\x06Tensor\x12\x11\n\x05shape\x18\x01 \x03(\x05\x42\x02\x10\x01\x12\x12\n\x06values\x18\x02 \x03(\x01\x42\x02\x10\x01\"\xcf\x02\n\x04Meta\x12\x0c\n\x04puid\x18\x01 \x01(\t\x12(\n\x04tags\x18\x02 \x03(\x0b\x32\x1a.seldon.tpu.Meta.TagsEntry\x12.\n\x07routing\x18\x03 \x03(\x0b\x32\x1d.seldon.tpu.Meta.RoutingEntry\x12\x36\n\x0brequestPath\x18\x04 \x03(\x0b\x32!.seldon.tpu.Meta.RequestPathEntry\x1a\x43\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.google.protobuf.Value:\x02\x38\x01\x1a.\n\x0cRoutingEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\x1a\x32\n\x10RequestPathEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"F\n\x11SeldonMessageList\x12\x31\n\x0eseldonMessages\x18\x01 \x03(\x0b\x32\x19.seldon.tpu.SeldonMessage\"\x8b\x01\n\x06Status\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\x12\x0c\n\x04info\x18\x02 \x01(\t\x12\x0e\n\x06reason\x18\x03 \x01(\t\x12-\n\x06status\x18\x04 \x01(\x0e\x32\x1d.seldon.tpu.Status.StatusFlag\"&\n\nStatusFlag\x12\x0b\n\x07SUCCESS\x10\x00\x12\x0b\n\x07\x46\x41ILURE\x10\x01\"\x9d\x01\n\x08\x46\x65\x65\x64\x62\x61\x63k\x12*\n\x07request\x18\x01 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\x12+\n\x08response\x18\x02 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\x12\x0e\n\x06reward\x18\x03 \x01(\x02\x12(\n\x05truth\x18\x04 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\"j\n\x0fRequestResponse\x12*\n\x07request\x18\x01 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\x12+\n\x08response\x18\x02 \x01(\x0b\x32\x19.seldon.tpu.SeldonMessage\"\xe8\x01\n\nServerInfo\x12\x17\n\x0f\x64\x65ployment_name\x18\x01 \x01(\t\x12\x16\n\x0epredictor_name\x18\x02 \x01(\t\x12\x14\n\x0c\x64\x65vice_count\x18\x03 \x01(\x05\x12\x10\n\x08platform\x18\x04 \x01(\t\x12\x15\n\rbatch_buckets\x18\x05 \x03(\x05\x12\r\n\x05\x64type\x18\x06 \x01(\t\x12.\n\x04mesh\x18\x07 \x03(\x0b\x32 .seldon.tpu.ServerInfo.MeshEntry\x1a+\n\tMeshEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\"\x13\n\x11ServerInfoRequest2\xeb\x02\n\x07Generic\x12H\n\x0eTransformInput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x12I\n\x0fTransformOutput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x12?\n\x05Route\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x12G\n\tAggregate\x12\x1d.seldon.tpu.SeldonMessageList\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x12\x41\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32J\n\x05Model\x12\x41\n\x07Predict\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32\x8c\x01\n\x06Router\x12?\n\x05Route\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x12\x41\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32W\n\x0bTransformer\x12H\n\x0eTransformInput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32^\n\x11OutputTransformer\x12I\n\x0fTransformOutput\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32S\n\x08\x43ombiner\x12G\n\tAggregate\x12\x1d.seldon.tpu.SeldonMessageList\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32\x8e\x01\n\x06Seldon\x12\x41\n\x07Predict\x12\x19.seldon.tpu.SeldonMessage\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x12\x41\n\x0cSendFeedback\x12\x14.seldon.tpu.Feedback\x1a\x19.seldon.tpu.SeldonMessage\"\x00\x32N\n\x05\x41\x64min\x12\x45\n\nServerInfo\x12\x1d.seldon.tpu.ServerInfoRequest\x1a\x16.seldon.tpu.ServerInfo\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'prediction_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSOR.fields_by_name['shape']._options = None
  _TENSOR.fields_by_name['shape']._serialized_options = b'\020\001'
  _TENSOR.fields_by_name['values']._options = None
  _TENSOR.fields_by_name['values']._serialized_options = b'\020\001'
  _META_TAGSENTRY._options = None
  _META_TAGSENTRY._serialized_options = b'8\001'
  _META_ROUTINGENTRY._options = None
  _META_ROUTINGENTRY._serialized_options = b'8\001'
  _META_REQUESTPATHENTRY._options = None
  _META_REQUESTPATHENTRY._serialized_options = b'8\001'
  _SERVERINFO_MESHENTRY._options = None
  _SERVERINFO_MESHENTRY._serialized_options = b'8\001'
  _SELDONMESSAGE._serialized_start=63
  _SELDONMESSAGE._serialized_end=239
  _DEFAULTDATA._serialized_start=241
  _DEFAULTDATA._serialized_end=368
  _TENSOR._serialized_start=370
  _TENSOR._serialized_end=417
  _META._serialized_start=420
  _META._serialized_end=755
  _META_TAGSENTRY._serialized_start=588
  _META_TAGSENTRY._serialized_end=655
  _META_ROUTINGENTRY._serialized_start=657
  _META_ROUTINGENTRY._serialized_end=703
  _META_REQUESTPATHENTRY._serialized_start=705
  _META_REQUESTPATHENTRY._serialized_end=755
  _SELDONMESSAGELIST._serialized_start=757
  _SELDONMESSAGELIST._serialized_end=827
  _STATUS._serialized_start=830
  _STATUS._serialized_end=969
  _STATUS_STATUSFLAG._serialized_start=931
  _STATUS_STATUSFLAG._serialized_end=969
  _FEEDBACK._serialized_start=972
  _FEEDBACK._serialized_end=1129
  _REQUESTRESPONSE._serialized_start=1131
  _REQUESTRESPONSE._serialized_end=1237
  _SERVERINFO._serialized_start=1240
  _SERVERINFO._serialized_end=1472
  _SERVERINFO_MESHENTRY._serialized_start=1429
  _SERVERINFO_MESHENTRY._serialized_end=1472
  _SERVERINFOREQUEST._serialized_start=1474
  _SERVERINFOREQUEST._serialized_end=1493
  _GENERIC._serialized_start=1496
  _GENERIC._serialized_end=1859
  _MODEL._serialized_start=1861
  _MODEL._serialized_end=1935
  _ROUTER._serialized_start=1938
  _ROUTER._serialized_end=2078
  _TRANSFORMER._serialized_start=2080
  _TRANSFORMER._serialized_end=2167
  _OUTPUTTRANSFORMER._serialized_start=2169
  _OUTPUTTRANSFORMER._serialized_end=2263
  _COMBINER._serialized_start=2265
  _COMBINER._serialized_end=2348
  _SELDON._serialized_start=2351
  _SELDON._serialized_end=2493
  _ADMIN._serialized_start=2495
  _ADMIN._serialized_end=2573
# @@protoc_insertion_point(module_scope)
