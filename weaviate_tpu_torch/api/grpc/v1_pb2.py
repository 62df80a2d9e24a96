# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: v1.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08v1.proto\x12\x0bweaviate.v1\x1a\x1cgoogle/protobuf/struct.proto\"\x1b\n\tTextArray\x12\x0e\n\x06values\x18\x01 \x03(\t\"\x1a\n\x08IntArray\x12\x0e\n\x06values\x18\x01 \x03(\x03\"\x1d\n\x0bNumberArray\x12\x0e\n\x06values\x18\x01 \x03(\x01\"\x1e\n\x0c\x42ooleanArray\x12\x0e\n\x06values\x18\x01 \x03(\x08\"T\n\x15NumberArrayProperties\x12\x12\n\x06values\x18\x01 \x03(\x01\x42\x02\x18\x01\x12\x11\n\tprop_name\x18\x02 \x01(\t\x12\x14\n\x0cvalues_bytes\x18\x03 \x01(\x0c\"7\n\x12IntArrayProperties\x12\x0e\n\x06values\x18\x01 \x03(\x03\x12\x11\n\tprop_name\x18\x02 \x01(\t\"8\n\x13TextArrayProperties\x12\x0e\n\x06values\x18\x01 \x03(\t\x12\x11\n\tprop_name\x18\x02 \x01(\t\";\n\x16\x42ooleanArrayProperties\x12\x0e\n\x06values\x18\x01 \x03(\x08\x12\x11\n\tprop_name\x18\x02 \x01(\t\"\xf1\x03\n\x15ObjectPropertiesValue\x12\x33\n\x12non_ref_properties\x18\x01 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\x43\n\x17number_array_properties\x18\x02 \x03(\x0b\x32\".weaviate.v1.NumberArrayProperties\x12=\n\x14int_array_properties\x18\x03 \x03(\x0b\x32\x1f.weaviate.v1.IntArrayProperties\x12?\n\x15text_array_properties\x18\x04 \x03(\x0b\x32 .weaviate.v1.TextArrayProperties\x12\x45\n\x18\x62oolean_array_properties\x18\x05 \x03(\x0b\x32#.weaviate.v1.BooleanArrayProperties\x12\x38\n\x11object_properties\x18\x06 \x03(\x0b\x32\x1d.weaviate.v1.ObjectProperties\x12\x43\n\x17object_array_properties\x18\x07 \x03(\x0b\x32\".weaviate.v1.ObjectArrayProperties\x12\x18\n\x10\x65mpty_list_props\x18\n \x03(\t\"^\n\x15ObjectArrayProperties\x12\x32\n\x06values\x18\x01 \x03(\x0b\x32\".weaviate.v1.ObjectPropertiesValue\x12\x11\n\tprop_name\x18\x02 \x01(\t\"X\n\x10ObjectProperties\x12\x31\n\x05value\x18\x01 \x01(\x0b\x32\".weaviate.v1.ObjectPropertiesValue\x12\x11\n\tprop_name\x18\x02 \x01(\t\"<\n\x07Vectors\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05index\x18\x02 \x01(\x04\x12\x14\n\x0cvector_bytes\x18\x03 \x01(\x0c\"M\n\x14GeoCoordinatesFilter\x12\x10\n\x08latitude\x18\x01 \x01(\x02\x12\x11\n\tlongitude\x18\x02 \x01(\x02\x12\x10\n\x08\x64istance\x18\x03 \x01(\x02\"T\n\x1b\x46ilterReferenceSingleTarget\x12\n\n\x02on\x18\x01 \x01(\t\x12)\n\x06target\x18\x02 \x01(\x0b\x32\x19.weaviate.v1.FilterTarget\"n\n\x1a\x46ilterReferenceMultiTarget\x12\n\n\x02on\x18\x01 \x01(\t\x12)\n\x06target\x18\x02 \x01(\x0b\x32\x19.weaviate.v1.FilterTarget\x12\x19\n\x11target_collection\x18\x03 \x01(\t\"\"\n\x14\x46ilterReferenceCount\x12\n\n\x02on\x18\x01 \x01(\t\"\xe4\x01\n\x0c\x46ilterTarget\x12\x12\n\x08property\x18\x01 \x01(\tH\x00\x12\x41\n\rsingle_target\x18\x02 \x01(\x0b\x32(.weaviate.v1.FilterReferenceSingleTargetH\x00\x12?\n\x0cmulti_target\x18\x03 \x01(\x0b\x32\'.weaviate.v1.FilterReferenceMultiTargetH\x00\x12\x32\n\x05\x63ount\x18\x04 \x01(\x0b\x32!.weaviate.v1.FilterReferenceCountH\x00\x42\x08\n\x06target\"\xfc\x06\n\x07\x46ilters\x12/\n\x08operator\x18\x01 \x01(\x0e\x32\x1d.weaviate.v1.Filters.Operator\x12\x0e\n\x02on\x18\x02 \x03(\tB\x02\x18\x01\x12%\n\x07\x66ilters\x18\x03 \x03(\x0b\x32\x14.weaviate.v1.Filters\x12\x14\n\nvalue_text\x18\x04 \x01(\tH\x00\x12\x13\n\tvalue_int\x18\x05 \x01(\x03H\x00\x12\x17\n\rvalue_boolean\x18\x06 \x01(\x08H\x00\x12\x16\n\x0cvalue_number\x18\x07 \x01(\x01H\x00\x12\x32\n\x10value_text_array\x18\t \x01(\x0b\x32\x16.weaviate.v1.TextArrayH\x00\x12\x30\n\x0fvalue_int_array\x18\n \x01(\x0b\x32\x15.weaviate.v1.IntArrayH\x00\x12\x38\n\x13value_boolean_array\x18\x0b \x01(\x0b\x32\x19.weaviate.v1.BooleanArrayH\x00\x12\x36\n\x12value_number_array\x18\x0c \x01(\x0b\x32\x18.weaviate.v1.NumberArrayH\x00\x12\x36\n\tvalue_geo\x18\r \x01(\x0b\x32!.weaviate.v1.GeoCoordinatesFilterH\x00\x12)\n\x06target\x18\x14 \x01(\x0b\x32\x19.weaviate.v1.FilterTarget\"\xe3\x02\n\x08Operator\x12\x18\n\x14OPERATOR_UNSPECIFIED\x10\x00\x12\x12\n\x0eOPERATOR_EQUAL\x10\x01\x12\x16\n\x12OPERATOR_NOT_EQUAL\x10\x02\x12\x19\n\x15OPERATOR_GREATER_THAN\x10\x03\x12\x1f\n\x1bOPERATOR_GREATER_THAN_EQUAL\x10\x04\x12\x16\n\x12OPERATOR_LESS_THAN\x10\x05\x12\x1c\n\x18OPERATOR_LESS_THAN_EQUAL\x10\x06\x12\x10\n\x0cOPERATOR_AND\x10\x07\x12\x0f\n\x0bOPERATOR_OR\x10\x08\x12\x1d\n\x19OPERATOR_WITHIN_GEO_RANGE\x10\t\x12\x11\n\rOPERATOR_LIKE\x10\n\x12\x14\n\x10OPERATOR_IS_NULL\x10\x0b\x12\x19\n\x15OPERATOR_CONTAINS_ANY\x10\x0c\x12\x19\n\x15OPERATOR_CONTAINS_ALL\x10\rB\x0c\n\ntest_value\"\x82\x0b\n\rSearchRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x0e\n\x06tenant\x18\n \x01(\t\x12=\n\x11\x63onsistency_level\x18\x0b \x01(\x0e\x32\x1d.weaviate.v1.ConsistencyLevelH\x00\x88\x01\x01\x12\x37\n\nproperties\x18\x14 \x01(\x0b\x32\x1e.weaviate.v1.PropertiesRequestH\x01\x88\x01\x01\x12\x33\n\x08metadata\x18\x15 \x01(\x0b\x32\x1c.weaviate.v1.MetadataRequestH\x02\x88\x01\x01\x12+\n\x08group_by\x18\x16 \x01(\x0b\x32\x14.weaviate.v1.GroupByH\x03\x88\x01\x01\x12\r\n\x05limit\x18\x1e \x01(\r\x12\x0e\n\x06offset\x18\x1f \x01(\r\x12\x0f\n\x07\x61utocut\x18  \x01(\r\x12\r\n\x05\x61\x66ter\x18! \x01(\t\x12$\n\x07sort_by\x18\" \x03(\x0b\x32\x13.weaviate.v1.SortBy\x12*\n\x07\x66ilters\x18( \x01(\x0b\x32\x14.weaviate.v1.FiltersH\x04\x88\x01\x01\x12/\n\rhybrid_search\x18) \x01(\x0b\x32\x13.weaviate.v1.HybridH\x05\x88\x01\x01\x12+\n\x0b\x62m25_search\x18* \x01(\x0b\x32\x11.weaviate.v1.BM25H\x06\x88\x01\x01\x12\x31\n\x0bnear_vector\x18+ \x01(\x0b\x32\x17.weaviate.v1.NearVectorH\x07\x88\x01\x01\x12\x31\n\x0bnear_object\x18, \x01(\x0b\x32\x17.weaviate.v1.NearObjectH\x08\x88\x01\x01\x12\x33\n\tnear_text\x18- \x01(\x0b\x32\x1b.weaviate.v1.NearTextSearchH\t\x88\x01\x01\x12\x35\n\nnear_image\x18. \x01(\x0b\x32\x1c.weaviate.v1.NearImageSearchH\n\x88\x01\x01\x12\x35\n\nnear_audio\x18/ \x01(\x0b\x32\x1c.weaviate.v1.NearAudioSearchH\x0b\x88\x01\x01\x12\x35\n\nnear_video\x18\x30 \x01(\x0b\x32\x1c.weaviate.v1.NearVideoSearchH\x0c\x88\x01\x01\x12\x35\n\nnear_depth\x18\x31 \x01(\x0b\x32\x1c.weaviate.v1.NearDepthSearchH\r\x88\x01\x01\x12\x39\n\x0cnear_thermal\x18\x32 \x01(\x0b\x32\x1e.weaviate.v1.NearThermalSearchH\x0e\x88\x01\x01\x12\x31\n\x08near_imu\x18\x33 \x01(\x0b\x32\x1a.weaviate.v1.NearIMUSearchH\x0f\x88\x01\x01\x12\x36\n\ngenerative\x18< \x01(\x0b\x32\x1d.weaviate.v1.GenerativeSearchH\x10\x88\x01\x01\x12(\n\x06rerank\x18= \x01(\x0b\x32\x13.weaviate.v1.RerankH\x11\x88\x01\x01\x12\x18\n\x0cuses_123_api\x18\x64 \x01(\x08\x42\x02\x18\x01\x12\x14\n\x0cuses_125_api\x18\x65 \x01(\x08\x42\x14\n\x12_consistency_levelB\r\n\x0b_propertiesB\x0b\n\t_metadataB\x0b\n\t_group_byB\n\n\x08_filtersB\x10\n\x0e_hybrid_searchB\x0e\n\x0c_bm25_searchB\x0e\n\x0c_near_vectorB\x0e\n\x0c_near_objectB\x0c\n\n_near_textB\r\n\x0b_near_imageB\r\n\x0b_near_audioB\r\n\x0b_near_videoB\r\n\x0b_near_depthB\x0f\n\r_near_thermalB\x0b\n\t_near_imuB\r\n\x0b_generativeB\t\n\x07_rerank\"L\n\x07GroupBy\x12\x0c\n\x04path\x18\x01 \x03(\t\x12\x18\n\x10number_of_groups\x18\x02 \x01(\x05\x12\x19\n\x11objects_per_group\x18\x03 \x01(\x05\")\n\x06SortBy\x12\x11\n\tascending\x18\x01 \x01(\x08\x12\x0c\n\x04path\x18\x02 \x03(\t\"\xdd\x01\n\x0fMetadataRequest\x12\x0c\n\x04uuid\x18\x01 \x01(\x08\x12\x0e\n\x06vector\x18\x02 \x01(\x08\x12\x1a\n\x12\x63reation_time_unix\x18\x03 \x01(\x08\x12\x1d\n\x15last_update_time_unix\x18\x04 \x01(\x08\x12\x10\n\x08\x64istance\x18\x05 \x01(\x08\x12\x11\n\tcertainty\x18\x06 \x01(\x08\x12\r\n\x05score\x18\x07 \x01(\x08\x12\x15\n\rexplain_score\x18\x08 \x01(\x08\x12\x15\n\ris_consistent\x18\t \x01(\x08\x12\x0f\n\x07vectors\x18\n \x03(\t\"\xd1\x01\n\x11PropertiesRequest\x12\x1a\n\x12non_ref_properties\x18\x01 \x03(\t\x12\x39\n\x0eref_properties\x18\x02 \x03(\x0b\x32!.weaviate.v1.RefPropertiesRequest\x12?\n\x11object_properties\x18\x03 \x03(\x0b\x32$.weaviate.v1.ObjectPropertiesRequest\x12$\n\x1creturn_all_nonref_properties\x18\x0b \x01(\x08\"\x8b\x01\n\x17ObjectPropertiesRequest\x12\x11\n\tprop_name\x18\x01 \x01(\t\x12\x1c\n\x14primitive_properties\x18\x02 \x03(\t\x12?\n\x11object_properties\x18\x03 \x03(\x0b\x32$.weaviate.v1.ObjectPropertiesRequest\"\xb1\x01\n\x14RefPropertiesRequest\x12\x1a\n\x12reference_property\x18\x01 \x01(\t\x12\x32\n\nproperties\x18\x02 \x01(\x0b\x32\x1e.weaviate.v1.PropertiesRequest\x12.\n\x08metadata\x18\x03 \x01(\x0b\x32\x1c.weaviate.v1.MetadataRequest\x12\x19\n\x11target_collection\x18\x04 \x01(\t\"\x98\x01\n\nNearVector\x12\x12\n\x06vector\x18\x01 \x03(\x02\x42\x02\x18\x01\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x14\n\x0cvector_bytes\x18\x04 \x01(\x0c\x12\x16\n\x0etarget_vectors\x18\x05 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"z\n\nNearObject\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"\xc5\x02\n\x0eNearTextSearch\x12\r\n\x05query\x18\x01 \x03(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x36\n\x07move_to\x18\x04 \x01(\x0b\x32 .weaviate.v1.NearTextSearch.MoveH\x02\x88\x01\x01\x12\x38\n\tmove_away\x18\x05 \x01(\x0b\x32 .weaviate.v1.NearTextSearch.MoveH\x03\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x06 \x03(\t\x1a\x36\n\x04Move\x12\r\n\x05\x66orce\x18\x01 \x01(\x02\x12\x10\n\x08\x63oncepts\x18\x02 \x03(\t\x12\r\n\x05uuids\x18\x03 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distanceB\n\n\x08_move_toB\x0c\n\n_move_away\"\x82\x01\n\x0fNearImageSearch\x12\r\n\x05image\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"\x82\x01\n\x0fNearAudioSearch\x12\r\n\x05\x61udio\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"\x82\x01\n\x0fNearVideoSearch\x12\r\n\x05video\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"\x82\x01\n\x0fNearDepthSearch\x12\r\n\x05\x64\x65pth\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"\x86\x01\n\x11NearThermalSearch\x12\x0f\n\x07thermal\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\"~\n\rNearIMUSearch\x12\x0b\n\x03imu\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\x0etarget_vectors\x18\x04 \x03(\tB\x0c\n\n_certaintyB\x0b\n\t_distance\")\n\x04\x42M25\x12\r\n\x05query\x18\x01 \x01(\t\x12\x12\n\nproperties\x18\x02 \x03(\t\"\xf2\x02\n\x06Hybrid\x12\r\n\x05query\x18\x01 \x01(\t\x12\x12\n\nproperties\x18\x02 \x03(\t\x12\x12\n\x06vector\x18\x03 \x03(\x02\x42\x02\x18\x01\x12\r\n\x05\x61lpha\x18\x04 \x01(\x02\x12\x33\n\x0b\x66usion_type\x18\x05 \x01(\x0e\x32\x1e.weaviate.v1.Hybrid.FusionType\x12\x14\n\x0cvector_bytes\x18\x06 \x01(\x0c\x12\x16\n\x0etarget_vectors\x18\x07 \x03(\t\x12.\n\tnear_text\x18\x08 \x01(\x0b\x32\x1b.weaviate.v1.NearTextSearch\x12,\n\x0bnear_vector\x18\t \x01(\x0b\x32\x17.weaviate.v1.NearVector\"a\n\nFusionType\x12\x1b\n\x17\x46USION_TYPE_UNSPECIFIED\x10\x00\x12\x16\n\x12\x46USION_TYPE_RANKED\x10\x01\x12\x1e\n\x1a\x46USION_TYPE_RELATIVE_SCORE\x10\x02\"m\n\x10GenerativeSearch\x12\x1e\n\x16single_response_prompt\x18\x01 \x01(\t\x12\x1d\n\x15grouped_response_task\x18\x02 \x01(\t\x12\x1a\n\x12grouped_properties\x18\x03 \x03(\t\"8\n\x06Rerank\x12\x10\n\x08property\x18\x01 \x01(\t\x12\x12\n\x05query\x18\x02 \x01(\tH\x00\x88\x01\x01\x42\x08\n\x06_query\"\xc3\x01\n\x0bSearchReply\x12\x0c\n\x04took\x18\x01 \x01(\x02\x12*\n\x07results\x18\x02 \x03(\x0b\x32\x19.weaviate.v1.SearchResult\x12&\n\x19generative_grouped_result\x18\x03 \x01(\tH\x00\x88\x01\x01\x12\x34\n\x10group_by_results\x18\x04 \x03(\x0b\x32\x1a.weaviate.v1.GroupByResultB\x1c\n\x1a_generative_grouped_result\"p\n\x0cSearchResult\x12\x31\n\nproperties\x18\x01 \x01(\x0b\x32\x1d.weaviate.v1.PropertiesResult\x12-\n\x08metadata\x18\x02 \x01(\x0b\x32\x1b.weaviate.v1.MetadataResult\"\x1c\n\x0bRerankReply\x12\r\n\x05score\x18\x01 \x01(\x01\"!\n\x0fGenerativeReply\x12\x0e\n\x06result\x18\x01 \x01(\t\"\x90\x02\n\rGroupByResult\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cmin_distance\x18\x02 \x01(\x02\x12\x14\n\x0cmax_distance\x18\x03 \x01(\x02\x12\x19\n\x11number_of_objects\x18\x04 \x01(\x03\x12*\n\x07objects\x18\x05 \x03(\x0b\x32\x19.weaviate.v1.SearchResult\x12-\n\x06rerank\x18\x06 \x01(\x0b\x32\x18.weaviate.v1.RerankReplyH\x00\x88\x01\x01\x12\x35\n\ngenerative\x18\x07 \x01(\x0b\x32\x1c.weaviate.v1.GenerativeReplyH\x01\x88\x01\x01\x42\t\n\x07_rerankB\r\n\x0b_generative\"\xef\x04\n\x0eMetadataResult\x12\n\n\x02id\x18\x01 \x01(\t\x12\x12\n\x06vector\x18\x02 \x03(\x02\x42\x02\x18\x01\x12\x1a\n\x12\x63reation_time_unix\x18\x03 \x01(\x03\x12\"\n\x1a\x63reation_time_unix_present\x18\x04 \x01(\x08\x12\x1d\n\x15last_update_time_unix\x18\x05 \x01(\x03\x12%\n\x1dlast_update_time_unix_present\x18\x06 \x01(\x08\x12\x10\n\x08\x64istance\x18\x07 \x01(\x02\x12\x18\n\x10\x64istance_present\x18\x08 \x01(\x08\x12\x11\n\tcertainty\x18\t \x01(\x02\x12\x19\n\x11\x63\x65rtainty_present\x18\n \x01(\x08\x12\r\n\x05score\x18\x0b \x01(\x02\x12\x15\n\rscore_present\x18\x0c \x01(\x08\x12\x15\n\rexplain_score\x18\r \x01(\t\x12\x1d\n\x15\x65xplain_score_present\x18\x0e \x01(\x08\x12\x1a\n\ris_consistent\x18\x0f \x01(\x08H\x00\x88\x01\x01\x12\x12\n\ngenerative\x18\x10 \x01(\t\x12\x1a\n\x12generative_present\x18\x11 \x01(\x08\x12\x1d\n\x15is_consistent_present\x18\x12 \x01(\x08\x12\x14\n\x0cvector_bytes\x18\x13 \x01(\x0c\x12\x13\n\x0bid_as_bytes\x18\x14 \x01(\x0c\x12\x14\n\x0crerank_score\x18\x15 \x01(\x01\x12\x1c\n\x14rerank_score_present\x18\x16 \x01(\x08\x12%\n\x07vectors\x18\x17 \x03(\x0b\x32\x14.weaviate.v1.VectorsB\x10\n\x0e_is_consistent\"\xba\x05\n\x10PropertiesResult\x12\x37\n\x12non_ref_properties\x18\x01 \x01(\x0b\x32\x17.google.protobuf.StructB\x02\x18\x01\x12\x33\n\tref_props\x18\x02 \x03(\x0b\x32 .weaviate.v1.RefPropertiesResult\x12\x19\n\x11target_collection\x18\x03 \x01(\t\x12-\n\x08metadata\x18\x04 \x01(\x0b\x32\x1b.weaviate.v1.MetadataResult\x12G\n\x17number_array_properties\x18\x05 \x03(\x0b\x32\".weaviate.v1.NumberArrayPropertiesB\x02\x18\x01\x12\x41\n\x14int_array_properties\x18\x06 \x03(\x0b\x32\x1f.weaviate.v1.IntArrayPropertiesB\x02\x18\x01\x12\x43\n\x15text_array_properties\x18\x07 \x03(\x0b\x32 .weaviate.v1.TextArrayPropertiesB\x02\x18\x01\x12I\n\x18\x62oolean_array_properties\x18\x08 \x03(\x0b\x32#.weaviate.v1.BooleanArrayPropertiesB\x02\x18\x01\x12<\n\x11object_properties\x18\t \x03(\x0b\x32\x1d.weaviate.v1.ObjectPropertiesB\x02\x18\x01\x12G\n\x17object_array_properties\x18\n \x03(\x0b\x32\".weaviate.v1.ObjectArrayPropertiesB\x02\x18\x01\x12.\n\rnon_ref_props\x18\x0b \x01(\x0b\x32\x17.weaviate.v1.Properties\x12\x1b\n\x13ref_props_requested\x18\x0c \x01(\x08\"[\n\x13RefPropertiesResult\x12\x31\n\nproperties\x18\x01 \x03(\x0b\x32\x1d.weaviate.v1.PropertiesResult\x12\x11\n\tprop_name\x18\x02 \x01(\t\"\x84\x01\n\nProperties\x12\x33\n\x06\x66ields\x18\x01 \x03(\x0b\x32#.weaviate.v1.Properties.FieldsEntry\x1a\x41\n\x0b\x46ieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12!\n\x05value\x18\x02 \x01(\x0b\x32\x12.weaviate.v1.Value:\x02\x38\x01\"\xb9\x03\n\x05Value\x12\x16\n\x0cnumber_value\x18\x01 \x01(\x01H\x00\x12\x1a\n\x0cstring_value\x18\x02 \x01(\tB\x02\x18\x01H\x00\x12\x14\n\nbool_value\x18\x03 \x01(\x08H\x00\x12/\n\x0cobject_value\x18\x04 \x01(\x0b\x32\x17.weaviate.v1.PropertiesH\x00\x12,\n\nlist_value\x18\x05 \x01(\x0b\x32\x16.weaviate.v1.ListValueH\x00\x12\x14\n\ndate_value\x18\x06 \x01(\tH\x00\x12\x14\n\nuuid_value\x18\x07 \x01(\tH\x00\x12\x13\n\tint_value\x18\x08 \x01(\x03H\x00\x12/\n\tgeo_value\x18\t \x01(\x0b\x32\x1a.weaviate.v1.GeoCoordinateH\x00\x12\x14\n\nblob_value\x18\n \x01(\tH\x00\x12/\n\x0bphone_value\x18\x0b \x01(\x0b\x32\x18.weaviate.v1.PhoneNumberH\x00\x12\x30\n\nnull_value\x18\x0c \x01(\x0e\x32\x1a.google.protobuf.NullValueH\x00\x12\x14\n\ntext_value\x18\r \x01(\tH\x00\x42\x06\n\x04kind\"\x91\x03\n\tListValue\x12&\n\x06values\x18\x01 \x03(\x0b\x32\x12.weaviate.v1.ValueB\x02\x18\x01\x12\x32\n\rnumber_values\x18\x02 \x01(\x0b\x32\x19.weaviate.v1.NumberValuesH\x00\x12.\n\x0b\x62ool_values\x18\x03 \x01(\x0b\x32\x17.weaviate.v1.BoolValuesH\x00\x12\x32\n\robject_values\x18\x04 \x01(\x0b\x32\x19.weaviate.v1.ObjectValuesH\x00\x12.\n\x0b\x64\x61te_values\x18\x05 \x01(\x0b\x32\x17.weaviate.v1.DateValuesH\x00\x12.\n\x0buuid_values\x18\x06 \x01(\x0b\x32\x17.weaviate.v1.UuidValuesH\x00\x12,\n\nint_values\x18\x07 \x01(\x0b\x32\x16.weaviate.v1.IntValuesH\x00\x12.\n\x0btext_values\x18\x08 \x01(\x0b\x32\x17.weaviate.v1.TextValuesH\x00\x42\x06\n\x04kind\"\x1e\n\x0cNumberValues\x12\x0e\n\x06values\x18\x01 \x01(\x0c\"\x1c\n\nTextValues\x12\x0e\n\x06values\x18\x01 \x03(\t\"\x1c\n\nBoolValues\x12\x0e\n\x06values\x18\x01 \x03(\x08\"7\n\x0cObjectValues\x12\'\n\x06values\x18\x01 \x03(\x0b\x32\x17.weaviate.v1.Properties\"\x1c\n\nDateValues\x12\x0e\n\x06values\x18\x01 \x03(\t\"\x1c\n\nUuidValues\x12\x0e\n\x06values\x18\x01 \x03(\t\"\x1b\n\tIntValues\x12\x0e\n\x06values\x18\x01 \x01(\x0c\"4\n\rGeoCoordinate\x12\x11\n\tlongitude\x18\x01 \x01(\x02\x12\x10\n\x08latitude\x18\x02 \x01(\x02\"\xa9\x01\n\x0bPhoneNumber\x12\x14\n\x0c\x63ountry_code\x18\x01 \x01(\x04\x12\x17\n\x0f\x64\x65\x66\x61ult_country\x18\x02 \x01(\t\x12\r\n\x05input\x18\x03 \x01(\t\x12\x1f\n\x17international_formatted\x18\x04 \x01(\t\x12\x10\n\x08national\x18\x05 \x01(\x04\x12\x1a\n\x12national_formatted\x18\x06 \x01(\t\x12\r\n\x05valid\x18\x07 \x01(\x08\"\x95\x01\n\x13\x42\x61tchObjectsRequest\x12)\n\x07objects\x18\x01 \x03(\x0b\x32\x18.weaviate.v1.BatchObject\x12=\n\x11\x63onsistency_level\x18\x02 \x01(\x0e\x32\x1d.weaviate.v1.ConsistencyLevelH\x00\x88\x01\x01\x42\x14\n\x12_consistency_level\"\xde\x07\n\x0b\x42\x61tchObject\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x12\n\x06vector\x18\x02 \x03(\x02\x42\x02\x18\x01\x12\x37\n\nproperties\x18\x03 \x01(\x0b\x32#.weaviate.v1.BatchObject.Properties\x12\x12\n\ncollection\x18\x04 \x01(\t\x12\x0e\n\x06tenant\x18\x05 \x01(\t\x12\x14\n\x0cvector_bytes\x18\x06 \x01(\x0c\x12%\n\x07vectors\x18\x17 \x03(\x0b\x32\x14.weaviate.v1.Vectors\x1a\x84\x05\n\nProperties\x12\x33\n\x12non_ref_properties\x18\x01 \x01(\x0b\x32\x17.google.protobuf.Struct\x12N\n\x17single_target_ref_props\x18\x02 \x03(\x0b\x32-.weaviate.v1.BatchObject.SingleTargetRefProps\x12L\n\x16multi_target_ref_props\x18\x03 \x03(\x0b\x32,.weaviate.v1.BatchObject.MultiTargetRefProps\x12\x43\n\x17number_array_properties\x18\x04 \x03(\x0b\x32\".weaviate.v1.NumberArrayProperties\x12=\n\x14int_array_properties\x18\x05 \x03(\x0b\x32\x1f.weaviate.v1.IntArrayProperties\x12?\n\x15text_array_properties\x18\x06 \x03(\x0b\x32 .weaviate.v1.TextArrayProperties\x12\x45\n\x18\x62oolean_array_properties\x18\x07 \x03(\x0b\x32#.weaviate.v1.BooleanArrayProperties\x12\x38\n\x11object_properties\x18\x08 \x03(\x0b\x32\x1d.weaviate.v1.ObjectProperties\x12\x43\n\x17object_array_properties\x18\t \x03(\x0b\x32\".weaviate.v1.ObjectArrayProperties\x12\x18\n\x10\x65mpty_list_props\x18\n \x03(\t\x1a\x38\n\x14SingleTargetRefProps\x12\r\n\x05uuids\x18\x01 \x03(\t\x12\x11\n\tprop_name\x18\x02 \x01(\t\x1aR\n\x13MultiTargetRefProps\x12\r\n\x05uuids\x18\x01 \x03(\t\x12\x11\n\tprop_name\x18\x02 \x01(\t\x12\x19\n\x11target_collection\x18\x03 \x01(\t\"\x88\x01\n\x11\x42\x61tchObjectsReply\x12\x0c\n\x04took\x18\x01 \x01(\x02\x12\x39\n\x06\x65rrors\x18\x02 \x03(\x0b\x32).weaviate.v1.BatchObjectsReply.BatchError\x1a*\n\nBatchError\x12\r\n\x05index\x18\x01 \x01(\x05\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\xe6\x01\n\x12\x42\x61tchDeleteRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12%\n\x07\x66ilters\x18\x02 \x01(\x0b\x32\x14.weaviate.v1.Filters\x12\x0f\n\x07verbose\x18\x03 \x01(\x08\x12\x0f\n\x07\x64ry_run\x18\x04 \x01(\x08\x12=\n\x11\x63onsistency_level\x18\x05 \x01(\x0e\x32\x1d.weaviate.v1.ConsistencyLevelH\x00\x88\x01\x01\x12\x13\n\x06tenant\x18\x06 \x01(\tH\x01\x88\x01\x01\x42\x14\n\x12_consistency_levelB\t\n\x07_tenant\"\x86\x01\n\x10\x42\x61tchDeleteReply\x12\x0c\n\x04took\x18\x01 \x01(\x02\x12\x0e\n\x06\x66\x61iled\x18\x02 \x01(\x03\x12\x0f\n\x07matches\x18\x03 \x01(\x03\x12\x12\n\nsuccessful\x18\x04 \x01(\x03\x12/\n\x07objects\x18\x05 \x03(\x0b\x32\x1e.weaviate.v1.BatchDeleteObject\"S\n\x11\x42\x61tchDeleteObject\x12\x0c\n\x04uuid\x18\x01 \x01(\x0c\x12\x12\n\nsuccessful\x18\x02 \x01(\x08\x12\x12\n\x05\x65rror\x18\x03 \x01(\tH\x00\x88\x01\x01\x42\x08\n\x06_error\"\\\n\x11TenantsGetRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12)\n\x05names\x18\x02 \x01(\x0b\x32\x18.weaviate.v1.TenantNamesH\x00\x42\x08\n\x06params\"\x1d\n\x0bTenantNames\x12\x0e\n\x06values\x18\x01 \x03(\t\"E\n\x0fTenantsGetReply\x12\x0c\n\x04took\x18\x01 \x01(\x02\x12$\n\x07tenants\x18\x02 \x03(\x0b\x32\x13.weaviate.v1.Tenant\"R\n\x06Tenant\x12\x0c\n\x04name\x18\x01 \x01(\t\x12:\n\x0f\x61\x63tivity_status\x18\x02 \x01(\x0e\x32!.weaviate.v1.TenantActivityStatus*\x89\x01\n\x10\x43onsistencyLevel\x12!\n\x1d\x43ONSISTENCY_LEVEL_UNSPECIFIED\x10\x00\x12\x19\n\x15\x43ONSISTENCY_LEVEL_ONE\x10\x01\x12\x1c\n\x18\x43ONSISTENCY_LEVEL_QUORUM\x10\x02\x12\x19\n\x15\x43ONSISTENCY_LEVEL_ALL\x10\x03*\xa8\x01\n\x14TenantActivityStatus\x12&\n\"TENANT_ACTIVITY_STATUS_UNSPECIFIED\x10\x00\x12\x1e\n\x1aTENANT_ACTIVITY_STATUS_HOT\x10\x01\x12\x1f\n\x1bTENANT_ACTIVITY_STATUS_COLD\x10\x02\x12!\n\x1dTENANT_ACTIVITY_STATUS_FROZEN\x10\x04\"\x04\x08\x03\x10\x03\x32\xbf\x02\n\x08Weaviate\x12@\n\x06Search\x12\x1a.weaviate.v1.SearchRequest\x1a\x18.weaviate.v1.SearchReply\"\x00\x12R\n\x0c\x42\x61tchObjects\x12 .weaviate.v1.BatchObjectsRequest\x1a\x1e.weaviate.v1.BatchObjectsReply\"\x00\x12O\n\x0b\x42\x61tchDelete\x12\x1f.weaviate.v1.BatchDeleteRequest\x1a\x1d.weaviate.v1.BatchDeleteReply\"\x00\x12L\n\nTenantsGet\x12\x1e.weaviate.v1.TenantsGetRequest\x1a\x1c.weaviate.v1.TenantsGetReply\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'v1_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NUMBERARRAYPROPERTIES.fields_by_name['values']._options = None
  _NUMBERARRAYPROPERTIES.fields_by_name['values']._serialized_options = b'\030\001'
  _FILTERS.fields_by_name['on']._options = None
  _FILTERS.fields_by_name['on']._serialized_options = b'\030\001'
  _SEARCHREQUEST.fields_by_name['uses_123_api']._options = None
  _SEARCHREQUEST.fields_by_name['uses_123_api']._serialized_options = b'\030\001'
  _NEARVECTOR.fields_by_name['vector']._options = None
  _NEARVECTOR.fields_by_name['vector']._serialized_options = b'\030\001'
  _HYBRID.fields_by_name['vector']._options = None
  _HYBRID.fields_by_name['vector']._serialized_options = b'\030\001'
  _METADATARESULT.fields_by_name['vector']._options = None
  _METADATARESULT.fields_by_name['vector']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['non_ref_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['non_ref_properties']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['number_array_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['number_array_properties']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['int_array_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['int_array_properties']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['text_array_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['text_array_properties']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['boolean_array_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['boolean_array_properties']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['object_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['object_properties']._serialized_options = b'\030\001'
  _PROPERTIESRESULT.fields_by_name['object_array_properties']._options = None
  _PROPERTIESRESULT.fields_by_name['object_array_properties']._serialized_options = b'\030\001'
  _PROPERTIES_FIELDSENTRY._options = None
  _PROPERTIES_FIELDSENTRY._serialized_options = b'8\001'
  _VALUE.fields_by_name['string_value']._options = None
  _VALUE.fields_by_name['string_value']._serialized_options = b'\030\001'
  _LISTVALUE.fields_by_name['values']._options = None
  _LISTVALUE.fields_by_name['values']._serialized_options = b'\030\001'
  _BATCHOBJECT.fields_by_name['vector']._options = None
  _BATCHOBJECT.fields_by_name['vector']._serialized_options = b'\030\001'
  _CONSISTENCYLEVEL._serialized_start=12444
  _CONSISTENCYLEVEL._serialized_end=12581
  _TENANTACTIVITYSTATUS._serialized_start=12584
  _TENANTACTIVITYSTATUS._serialized_end=12752
  _TEXTARRAY._serialized_start=55
  _TEXTARRAY._serialized_end=82
  _INTARRAY._serialized_start=84
  _INTARRAY._serialized_end=110
  _NUMBERARRAY._serialized_start=112
  _NUMBERARRAY._serialized_end=141
  _BOOLEANARRAY._serialized_start=143
  _BOOLEANARRAY._serialized_end=173
  _NUMBERARRAYPROPERTIES._serialized_start=175
  _NUMBERARRAYPROPERTIES._serialized_end=259
  _INTARRAYPROPERTIES._serialized_start=261
  _INTARRAYPROPERTIES._serialized_end=316
  _TEXTARRAYPROPERTIES._serialized_start=318
  _TEXTARRAYPROPERTIES._serialized_end=374
  _BOOLEANARRAYPROPERTIES._serialized_start=376
  _BOOLEANARRAYPROPERTIES._serialized_end=435
  _OBJECTPROPERTIESVALUE._serialized_start=438
  _OBJECTPROPERTIESVALUE._serialized_end=935
  _OBJECTARRAYPROPERTIES._serialized_start=937
  _OBJECTARRAYPROPERTIES._serialized_end=1031
  _OBJECTPROPERTIES._serialized_start=1033
  _OBJECTPROPERTIES._serialized_end=1121
  _VECTORS._serialized_start=1123
  _VECTORS._serialized_end=1183
  _GEOCOORDINATESFILTER._serialized_start=1185
  _GEOCOORDINATESFILTER._serialized_end=1262
  _FILTERREFERENCESINGLETARGET._serialized_start=1264
  _FILTERREFERENCESINGLETARGET._serialized_end=1348
  _FILTERREFERENCEMULTITARGET._serialized_start=1350
  _FILTERREFERENCEMULTITARGET._serialized_end=1460
  _FILTERREFERENCECOUNT._serialized_start=1462
  _FILTERREFERENCECOUNT._serialized_end=1496
  _FILTERTARGET._serialized_start=1499
  _FILTERTARGET._serialized_end=1727
  _FILTERS._serialized_start=1730
  _FILTERS._serialized_end=2622
  _FILTERS_OPERATOR._serialized_start=2253
  _FILTERS_OPERATOR._serialized_end=2608
  _SEARCHREQUEST._serialized_start=2625
  _SEARCHREQUEST._serialized_end=4035
  _GROUPBY._serialized_start=4037
  _GROUPBY._serialized_end=4113
  _SORTBY._serialized_start=4115
  _SORTBY._serialized_end=4156
  _METADATAREQUEST._serialized_start=4159
  _METADATAREQUEST._serialized_end=4380
  _PROPERTIESREQUEST._serialized_start=4383
  _PROPERTIESREQUEST._serialized_end=4592
  _OBJECTPROPERTIESREQUEST._serialized_start=4595
  _OBJECTPROPERTIESREQUEST._serialized_end=4734
  _REFPROPERTIESREQUEST._serialized_start=4737
  _REFPROPERTIESREQUEST._serialized_end=4914
  _NEARVECTOR._serialized_start=4917
  _NEARVECTOR._serialized_end=5069
  _NEAROBJECT._serialized_start=5071
  _NEAROBJECT._serialized_end=5193
  _NEARTEXTSEARCH._serialized_start=5196
  _NEARTEXTSEARCH._serialized_end=5521
  _NEARTEXTSEARCH_MOVE._serialized_start=5414
  _NEARTEXTSEARCH_MOVE._serialized_end=5468
  _NEARIMAGESEARCH._serialized_start=5524
  _NEARIMAGESEARCH._serialized_end=5654
  _NEARAUDIOSEARCH._serialized_start=5657
  _NEARAUDIOSEARCH._serialized_end=5787
  _NEARVIDEOSEARCH._serialized_start=5790
  _NEARVIDEOSEARCH._serialized_end=5920
  _NEARDEPTHSEARCH._serialized_start=5923
  _NEARDEPTHSEARCH._serialized_end=6053
  _NEARTHERMALSEARCH._serialized_start=6056
  _NEARTHERMALSEARCH._serialized_end=6190
  _NEARIMUSEARCH._serialized_start=6192
  _NEARIMUSEARCH._serialized_end=6318
  _BM25._serialized_start=6320
  _BM25._serialized_end=6361
  _HYBRID._serialized_start=6364
  _HYBRID._serialized_end=6734
  _HYBRID_FUSIONTYPE._serialized_start=6637
  _HYBRID_FUSIONTYPE._serialized_end=6734
  _GENERATIVESEARCH._serialized_start=6736
  _GENERATIVESEARCH._serialized_end=6845
  _RERANK._serialized_start=6847
  _RERANK._serialized_end=6903
  _SEARCHREPLY._serialized_start=6906
  _SEARCHREPLY._serialized_end=7101
  _SEARCHRESULT._serialized_start=7103
  _SEARCHRESULT._serialized_end=7215
  _RERANKREPLY._serialized_start=7217
  _RERANKREPLY._serialized_end=7245
  _GENERATIVEREPLY._serialized_start=7247
  _GENERATIVEREPLY._serialized_end=7280
  _GROUPBYRESULT._serialized_start=7283
  _GROUPBYRESULT._serialized_end=7555
  _METADATARESULT._serialized_start=7558
  _METADATARESULT._serialized_end=8181
  _PROPERTIESRESULT._serialized_start=8184
  _PROPERTIESRESULT._serialized_end=8882
  _REFPROPERTIESRESULT._serialized_start=8884
  _REFPROPERTIESRESULT._serialized_end=8975
  _PROPERTIES._serialized_start=8978
  _PROPERTIES._serialized_end=9110
  _PROPERTIES_FIELDSENTRY._serialized_start=9045
  _PROPERTIES_FIELDSENTRY._serialized_end=9110
  _VALUE._serialized_start=9113
  _VALUE._serialized_end=9554
  _LISTVALUE._serialized_start=9557
  _LISTVALUE._serialized_end=9958
  _NUMBERVALUES._serialized_start=9960
  _NUMBERVALUES._serialized_end=9990
  _TEXTVALUES._serialized_start=9992
  _TEXTVALUES._serialized_end=10020
  _BOOLVALUES._serialized_start=10022
  _BOOLVALUES._serialized_end=10050
  _OBJECTVALUES._serialized_start=10052
  _OBJECTVALUES._serialized_end=10107
  _DATEVALUES._serialized_start=10109
  _DATEVALUES._serialized_end=10137
  _UUIDVALUES._serialized_start=10139
  _UUIDVALUES._serialized_end=10167
  _INTVALUES._serialized_start=10169
  _INTVALUES._serialized_end=10196
  _GEOCOORDINATE._serialized_start=10198
  _GEOCOORDINATE._serialized_end=10250
  _PHONENUMBER._serialized_start=10253
  _PHONENUMBER._serialized_end=10422
  _BATCHOBJECTSREQUEST._serialized_start=10425
  _BATCHOBJECTSREQUEST._serialized_end=10574
  _BATCHOBJECT._serialized_start=10577
  _BATCHOBJECT._serialized_end=11567
  _BATCHOBJECT_PROPERTIES._serialized_start=10781
  _BATCHOBJECT_PROPERTIES._serialized_end=11425
  _BATCHOBJECT_SINGLETARGETREFPROPS._serialized_start=11427
  _BATCHOBJECT_SINGLETARGETREFPROPS._serialized_end=11483
  _BATCHOBJECT_MULTITARGETREFPROPS._serialized_start=11485
  _BATCHOBJECT_MULTITARGETREFPROPS._serialized_end=11567
  _BATCHOBJECTSREPLY._serialized_start=11570
  _BATCHOBJECTSREPLY._serialized_end=11706
  _BATCHOBJECTSREPLY_BATCHERROR._serialized_start=11664
  _BATCHOBJECTSREPLY_BATCHERROR._serialized_end=11706
  _BATCHDELETEREQUEST._serialized_start=11709
  _BATCHDELETEREQUEST._serialized_end=11939
  _BATCHDELETEREPLY._serialized_start=11942
  _BATCHDELETEREPLY._serialized_end=12076
  _BATCHDELETEOBJECT._serialized_start=12078
  _BATCHDELETEOBJECT._serialized_end=12161
  _TENANTSGETREQUEST._serialized_start=12163
  _TENANTSGETREQUEST._serialized_end=12255
  _TENANTNAMES._serialized_start=12257
  _TENANTNAMES._serialized_end=12286
  _TENANTSGETREPLY._serialized_start=12288
  _TENANTSGETREPLY._serialized_end=12357
  _TENANT._serialized_start=12359
  _TENANT._serialized_end=12441
  _WEAVIATE._serialized_start=12755
  _WEAVIATE._serialized_end=13074
# @@protoc_insertion_point(module_scope)
