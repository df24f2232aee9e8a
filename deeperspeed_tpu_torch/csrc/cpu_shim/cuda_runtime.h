// CPU shim stand-in for <cuda_runtime.h>
#pragma once
#include "cuda_shim.h"
